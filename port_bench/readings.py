"""The readings that the check's limits are set from, on the card:

    python3 port_bench/readings.py --workload <cell> --seeds 1,2,3 [--control]

For each seed, the requests that a run's check compares (the first
``check`` requests of the mix, or one batch) go through the cell's timed
entry point, and the check compares their answers with the reference;
each seed's numbers are printed as one JSON line. The pool is drawn from
the seed here, also where the mix fixes it by a ``pool_seed`` for its
timed runs, so that every seed reads other scans or other noise. With ``--control`` the
program is replaced by the control, the step below the configuration's
precision: for ``maha_simple`` the reference itself with bfloat16 rows and
float32 arithmetic (the kernels' bf16-row instantiation, which neither
entry point exposes), for ``m3500`` the port's own pose graph at
``dtype=float32``. A limit lies above every reading of the program and
below every reading of the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))

from harness import runner, traffic  # noqa: E402
from harness.manifest import Manifest, load_module, read_json  # noqa: E402


class _BF16Reference:
    """The maha control in the program's place: each scan registered by
    the reference with bf16 rows in float32."""

    def __init__(self, system):
        from reference import ndt as ref_ndt

        self._register = ref_ndt.register
        self._map = ref_ndt.build_map(system.points, system.cfg["map_resolution"])
        self._local = system.local

    def serve(self, items):
        answers = []
        for i in items:
            r = self._register(self._map, self._local[i], bf16_rows=True)
            pose = types.SimpleNamespace(rotation=r.rotation, translation=r.translation)
            answers.append((pose, r.final_cost))
        return answers, {}


def readings(workload: str, seeds, control: bool = False, device: str = "cuda", root=ROOT):
    """One dict of the check's numbers a seed."""
    manifest = Manifest(root)
    cell = manifest.cell(workload)
    cfg, mix = read_json(cell.config_file), read_json(cell.traffic_file)
    module = load_module(cell.config_module, f"pb_config_{cell.config}")
    entry = load_module(cell.entry_module, f"pb_entry_{cell.config}_{mix['entry']}")
    drawn = {k: v for k, v in mix.items() if k != "pool_seed"}
    out = []
    for seed in seeds:
        plan = traffic.plan(drawn, seed)
        kwargs = {}
        if control and cell.config == "m3500":
            import torch

            kwargs["dtype"] = torch.float32
        system = module.System(cfg, plan, device, **kwargs)
        if control and cell.config != "m3500":
            serve = _BF16Reference(system).serve
        else:
            serve = entry.make(system)
        requests = [traffic.send(serve, plan, k, False)
                    for k in range(max(1, plan.check // plan.batch))]
        window = traffic.Window(requests[0].start, requests[-1].end, requests)
        serve = None
        system.release()
        checks = runner.check(entry, system, window, traffic.rng(seed, 1), cfg["limits"])
        out.append({"workload": workload, "seed": seed, "control": control,
                    **{c.name: c.value for c in checks}})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(1, str(ROOT))
    for row in readings(args.workload, [int(s) for s in args.seeds.split(",")], args.control):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
