"""The port's incremental-mapping example driven as a library (the mirror
of tests/test_incremental_mapping.py), on the CPU: scan-to-map odometry
against a growing ``NdtMapAccumulator`` map stays at single-registration
error while the scan-to-scan chain drifts.

Same assertions as the JAX test; 24 frames instead of 30 (1.5 laps of 16
frames, 22.5 degrees between frames instead of 18) to keep the file near
20 s on one worker.
"""

import pytest
import torch

from nonlinear_optimizer_for_slam_tpu_torch.examples import incremental_mapping


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_scan_to_map_beats_chain(capsys):
    e_map, e_chain, f_map, f_chain = incremental_mapping.main(
        n_frames=24, n_scan=900, verbose=True, device="cpu"
    )
    out = capsys.readouterr().out
    assert "scan-to-map   error:" in out and "map-size buckets" in out
    # single-registration-level accuracy, no compounding
    assert e_map < 0.08, e_map
    assert f_map < 0.10, f_map
    # the chain drifts well past it by the end
    assert f_map < 0.6 * f_chain, (f_map, f_chain)
