"""The port's full-SLAM example driven as a library (the mirror of
tests/test_full_slam.py), on the CPU: the registrar's scan odometry,
keyframe loop closures and the fixed-lag smoother, with the edges
whitened by the registrations' own information or by calibrated scalars.

Same sizes and assertions as the JAX test (44 frames of 700 points, a
keyframe every 5). At 24 frames the calibrated mode's planted switch
settled at 0.18, above the 0.15 bound: the shorter second lap gives the
window fewer good loops to outvote it, so the file keeps the JAX size and
takes about 50 s on one worker.
"""

import pytest
import torch

from nonlinear_optimizer_for_slam_tpu_torch.examples import full_slam


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("whitening", ["information", "calibrated"])
def test_full_slam_beats_odometry_and_rejects_outlier(capsys, whitening):
    e_sm, e_od = full_slam.main(
        n_frames=44, n_scan=700, keyframe_every=5, verbose=True, whitening=whitening,
        device="cpu",
    )
    out = capsys.readouterr().out
    # the planted false loop must have been switched off
    assert "planted FALSE loop" in out
    line = [l for l in out.splitlines() if "switch after update" in l][0]
    assert float(line.split()[-1]) < 0.15, line
    # online accuracy: loops must beat raw odometry clearly
    assert e_sm < 0.6 * e_od, (e_sm, e_od)
    assert e_sm < 0.2, e_sm
