"""One scan a request through ``pipelines.registration.register_ndt`` with
``MahalanobisDistanceMinimizer``: the host-driven outer loop, one maha6
launch an LM evaluation."""

from __future__ import annotations


def make(system):
    from nonlinear_optimizer_for_slam_tpu_torch.pipelines import registration

    port = system.port
    minimizer = port.MahalanobisDistanceMinimizer(device=system.device).set_loss_function(system.loss)

    def serve(scans):
        res = registration.register_ndt(system.ndt_map, scans[0], system.identity, minimizer,
                                        system.options, **system.matching)
        return [(res.pose, res.summaries[-1].final_cost)], {}

    return system.counted(serve)
