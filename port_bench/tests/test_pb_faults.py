"""A run with the timed path broken underneath reports ``correct: false``.

Each cell runs on the CPU (the harness's look for a card skipped,
the configurations cut to the sizes of ``small_root``) once as it is and
once for each fault the cell can have: a step that returns its state
unchanged, half of a batch left out (the batch cell), an answer altered
where it is produced. No cell spans chips, so no exchange between chips
can be left out."""

from __future__ import annotations

import time

import numpy as np
import pytest

from harness import runner

SHIFT = 1e-3  # metres added to an answer's translation


def _run(root, cell):
    return runner.run(root, cell, 20261018, 1.0, False, time.perf_counter(), device="cpu")


def _shifted(pose):
    from nonlinear_optimizer_for_slam_tpu_torch import Pose

    return Pose(pose.rotation, pose.translation + SHIFT)


def _scan_faults(monkeypatch, fault):
    from nonlinear_optimizer_for_slam_tpu_torch.pipelines import registration
    from nonlinear_optimizer_for_slam_tpu_torch.solvers import minimizers

    if fault == "unchanged":
        solve = minimizers.MahalanobisDistanceMinimizer.solve
        monkeypatch.setattr(minimizers.MahalanobisDistanceMinimizer, "solve",
                            lambda self, options, data, pose: (pose, solve(self, options, data, pose)[1]))
    else:
        register = registration.register_ndt

        def altered(*args, **kw):
            res = register(*args, **kw)
            res.pose = _shifted(res.pose)
            return res

        monkeypatch.setattr(registration, "register_ndt", altered)


def _batch_faults(monkeypatch, fault):
    from nonlinear_optimizer_for_slam_tpu_torch.pipelines import fused_registration as fr

    if fault == "unchanged":
        step = fr._Machine._lm_step

        def frozen(self, t, q, data, lam):
            _, _, cost, step_norm, grad_norm = step(self, t, q, data, lam)
            return t, q, cost, 0.0 * step_norm, 0.0 * grad_norm

        monkeypatch.setattr(fr._Machine, "_lm_step", frozen)
        return
    register_batch = fr.NdtRegistrar.register_batch

    def broken(self, scans, poses, mode="lockstep"):
        if fault == "half":  # the second half answered with the first half's results
            half = register_batch(self, scans[: len(scans) // 2], poses[: len(scans) // 2], mode)
            return half + half
        results = register_batch(self, scans, poses, mode)
        for r in results:
            r.pose = _shifted(r.pose)
        return results

    monkeypatch.setattr(fr.NdtRegistrar, "register_batch", broken)


def _graph_faults(monkeypatch, fault):
    from nonlinear_optimizer_for_slam_tpu_torch.solvers.pose_graph import PoseGraphOptimizer2D

    solve = PoseGraphOptimizer2D.solve

    def broken(self, options=None):
        before = {v: self.get_pose(v) for v in self.pose_indices()}
        out = solve(self, options)
        if fault == "unchanged":
            for v, xyt in before.items():
                self.set_pose(v, xyt)
        else:
            v = self.pose_indices()[1]
            self.set_pose(v, self.get_pose(v) + np.array([SHIFT, 0.0, 0.0]))
        return out

    monkeypatch.setattr(PoseGraphOptimizer2D, "solve", broken)


CASES = [
    ("maha_simple.scan", _scan_faults, ["unchanged", "altered"]),
    ("maha_simple.serve16", _batch_faults, ["unchanged", "half", "altered"]),
    ("m3500.solve", _graph_faults, ["unchanged", "altered"]),
]


@pytest.mark.parametrize("cell,fault", [("maha_simple.scan", None), ("maha_simple.serve16", None),
                                        ("m3500.solve", None)]
                         + [(c, f) for c, _, faults in CASES for f in faults])
def test_a_broken_timed_path_is_not_correct(small_root, monkeypatch, cell, fault):
    if fault is not None:
        dict((c, patch) for c, patch, _ in CASES)[cell](monkeypatch, fault)
    out = _run(small_root, cell)
    assert out["correct"] is (fault is None), out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
