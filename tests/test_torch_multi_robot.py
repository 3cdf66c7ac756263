"""The port's multi-robot map-merge example driven as a library (the
mirror of tests/test_multi_robot.py, same sizes and assertions), on the
CPU: two scan-odometry trajectories in different frames, rendezvous NDT
registrations, one joint switchable pose graph in float64; the planted
false inter-robot match is switched off.
"""

import pytest
import torch

from nonlinear_optimizer_for_slam_tpu_torch.examples import multi_robot_map_merge


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_map_merge_beats_naive_alignment_and_rejects_false_rendezvous(capsys):
    e_b, e_naive, false_switch, switches = multi_robot_map_merge.main(
        n_frames=16, n_scan=700, keyframe_every=3, verbose=True, device="cpu"
    )
    assert "planted FALSE rendezvous" in capsys.readouterr().out
    # the joint merge clearly beats placing B by the first rendezvous only
    assert e_b < 0.75 * e_naive, (e_b, e_naive)
    assert e_b < 0.2, e_b
    # the planted false inter-robot match is switched off...
    assert false_switch < 0.15, false_switch
    # ...while the genuine rendezvous and lap-closure edges stay active
    assert (switches[:-1] > 0.6).all(), switches
