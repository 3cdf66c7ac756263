"""The port's small utilities against the JAX package's, mirroring
tests/test_utils.py: ``TimeChecker`` aggregation and report, the
``UnorderedBimap``, and the ``.npz`` checkpoints, whose keys and kind tags
are the JAX package's: an ``NdtMap`` and a ``Pose`` saved by either package
load in the other with every array exactly equal. Also the port's own
``device_time`` (its fence on CPU tensors) and ``trace`` (a
``torch.profiler`` trace file written where asked).
"""

import os
import time

import numpy as np
import pytest
import torch

import nonlinear_optimizer_for_slam_tpu as nls
from nonlinear_optimizer_for_slam_tpu.pipelines import ndt as jndt
from nonlinear_optimizer_for_slam_tpu.utils import checkpoint as jcheckpoint
from nonlinear_optimizer_for_slam_tpu.utils import time_checker as jtime_checker
import nonlinear_optimizer_for_slam_tpu_torch as port
from nonlinear_optimizer_for_slam_tpu_torch.pipelines import ndt
from nonlinear_optimizer_for_slam_tpu_torch.utils import (
    TimeChecker,
    TimeCheckerManager,
    UnorderedBimap,
    check_exec_time,
    checkpoint,
    device_time,
)
from nonlinear_optimizer_for_slam_tpu_torch.utils import time_checker


def test_time_checker_aggregates():
    mgr = TimeCheckerManager.instance()
    mgr.reset()
    for _ in range(3):
        with TimeChecker("unit/label"):
            time.sleep(0.002)
    assert len(mgr.samples["unit/label"]) == 3
    assert all(s >= 1.0 for s in mgr.samples["unit/label"])
    lines = mgr.report_lines()
    assert any("unit/label" in ln for ln in lines)
    # the JAX package's report of the same samples, line for line
    jmgr = jtime_checker.TimeCheckerManager()
    jmgr.samples = {k: list(v) for k, v in mgr.samples.items()}
    assert jmgr.report_lines() == lines
    mgr.reset()


def test_check_exec_time_auto_label():
    mgr = TimeCheckerManager.instance()
    mgr.reset()
    with check_exec_time():
        pass
    (label,) = mgr.samples.keys()
    assert "test_torch_utils.py" in label and "test_check_exec_time_auto_label" in label
    mgr.reset()


def test_min_time_threshold_filters_report():
    mgr = TimeCheckerManager.instance()
    mgr.reset()
    mgr.register_time("fast", 0.01)
    mgr.register_time("slow", 100.0)
    mgr.set_min_time_threshold(1.0)
    lines = "\n".join(mgr.report_lines())
    assert "slow" in lines and "fast" not in lines
    mgr.set_min_time_threshold(0.0)
    mgr.reset()


def test_bimap_roundtrip_and_deletes():
    bm = UnorderedBimap()
    assert bm.insert(1, "a") and bm.insert(2, "b")
    assert not bm.insert(1, "z")  # duplicate key
    assert not bm.insert(3, "a")  # duplicate value
    assert bm.get_value(1) == "a" and bm.get_key("b") == 2
    # delete_by_value: the reference's buggy path (unordered_bimap.h:63)
    assert bm.delete_by_value("a")
    assert not bm.has_key(1) and not bm.has_value("a")
    assert bm.delete_by_key(2)
    assert len(bm) == 0
    assert not bm.delete_by_value("missing")


def _same_map(a, b):
    for field in ("means", "sqrt_informations", "informations", "counts", "valid"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_checkpoint_ndt_map_roundtrip(tmp_path, rng):
    pts = rng.uniform(-3, 3, size=(5000, 3))
    m = ndt.build_ndt_map(pts, 1.0)
    p = str(tmp_path / "map.npz")
    checkpoint.save_ndt_map(p, m)
    _same_map(checkpoint.load_ndt_map(p), m)


def test_checkpoint_pose_roundtrip(tmp_path):
    pose = port.Pose.from_axis_angle(0.3, [1.0, 2.0, 3.0], [0.1, 0.2, 0.3])
    p = str(tmp_path / "pose.npz")
    checkpoint.save_pose(p, pose, outer_iteration=np.asarray(4), costs=np.arange(3.0))
    pose2, extras = checkpoint.load_pose(p)
    np.testing.assert_allclose(pose2.matrix(), pose.matrix())
    assert int(extras["outer_iteration"]) == 4
    np.testing.assert_allclose(extras["costs"], [0.0, 1.0, 2.0])


def test_checkpoint_kind_mismatch(tmp_path, rng):
    pts = rng.uniform(-1, 1, size=(500, 3))
    p = str(tmp_path / "map.npz")
    checkpoint.save_ndt_map(p, ndt.build_ndt_map(pts, 1.0))
    with pytest.raises(ValueError, match="not a pose checkpoint"):
        checkpoint.load_pose(p)
    q = str(tmp_path / "pose.npz")
    checkpoint.save_pose(q, port.Pose.identity())
    with pytest.raises(ValueError, match="not an NDT map checkpoint"):
        checkpoint.load_ndt_map(q)


def test_time_checker_save_file(tmp_path):
    mgr = TimeCheckerManager.instance()
    mgr.reset()
    mgr.register_time("saved/label", 5.0)
    p = str(tmp_path / "report.txt")
    mgr.save_file(p)
    text = open(p).read()
    assert "saved/label" in text and "Time Analysis" in text
    mgr.reset()


def test_checkpoints_cross_load_between_packages(tmp_path, rng):
    """A map and a pose written by the JAX package load in the port, and
    the reverse, every array exactly equal."""
    pts = rng.uniform(-3, 3, size=(3000, 3))
    jmap = jndt.build_ndt_map(pts, 1.0)
    tmap = ndt.build_ndt_map(pts, 1.0)
    jpath, tpath = str(tmp_path / "jax_map.npz"), str(tmp_path / "port_map.npz")
    jcheckpoint.save_ndt_map(jpath, jmap)
    checkpoint.save_ndt_map(tpath, tmap)
    _same_map(checkpoint.load_ndt_map(jpath), jmap)
    _same_map(jcheckpoint.load_ndt_map(tpath), tmap)

    jpose = nls.Pose.from_axis_angle(0.4, [0.3, -1.0, 0.2], [1.0, -2.0, 0.5])
    tpose = port.Pose(jpose.rotation, jpose.translation)
    extras = {"outer_iteration": np.asarray(7), "costs": rng.normal(size=5)}
    jcheckpoint.save_pose(str(tmp_path / "jax_pose.npz"), jpose, **extras)
    checkpoint.save_pose(str(tmp_path / "port_pose.npz"), tpose, **extras)
    for load, path, want in (
        (checkpoint.load_pose, "jax_pose.npz", jpose),
        (jcheckpoint.load_pose, "port_pose.npz", tpose),
    ):
        got, got_extras = load(str(tmp_path / path))
        np.testing.assert_array_equal(got.rotation, want.rotation)
        np.testing.assert_array_equal(got.translation, want.translation)
        assert sorted(got_extras) == sorted(extras)
        for k, v in extras.items():
            np.testing.assert_array_equal(got_extras[k], v)


def test_device_time_and_trace(tmp_path):
    mgr = TimeCheckerManager.instance()
    mgr.reset()
    with device_time("unit/device") as holder:
        holder["out"] = (torch.ones(3) * 2.0, {"h": torch.zeros(2)})
    assert len(mgr.samples["unit/device"]) == 1 and mgr.samples["unit/device"][0] >= 0.0
    mgr.reset()
    log_dir = str(tmp_path / "trace")
    with time_checker.trace("unit/trace", log_dir=log_dir):
        torch.ones(8).sum()
    files = os.listdir(log_dir)
    assert any(f.endswith(".pt.trace.json") for f in files), files
    text = open(os.path.join(log_dir, files[0])).read()
    assert "unit/trace" in text
