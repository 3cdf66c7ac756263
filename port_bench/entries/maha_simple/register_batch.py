"""A batch of scans a request through ``NdtRegistrar.register_batch`` in
lockstep: the device-resident registrar machine."""

from __future__ import annotations


def make(system):
    registrar = system.port.NdtRegistrar(system.ndt_map, system.options, system.loss,
                                         device=system.device, **system.matching)

    def serve(scans):
        results = registrar.register_batch(scans, [system.identity] * len(scans))
        stats = registrar.run_stats()
        return [(r.pose, r.final_cost) for r in results], {
            "steps": stats["steps"], "wasted_steps": stats["wasted_steps"],
            "host_reads": stats["host_reads"], "batches": 1}

    return system.counted(serve)
