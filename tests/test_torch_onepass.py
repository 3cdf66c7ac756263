"""The one-pass reduction of maha6, maha3, maha3c, reproj and p2p
(``csrc/onepass.cuh``), checked on the CPU.

The kernel cannot run here, so three things that fix its results are
checked without it:

- its geometry: g++ builds the header's ``__host__ __device__`` functions
  (tiles of N lanes, the workspace size, which lane holds which output of
  the reduce-scatter, which N take the cluster finish, the finishing
  lanes' batch of reads) into a harness, held against the Python copy that
  sizes the workspace and chooses the finish, against the emulation, and
  against a simulation of the reduce-scatter;
- its order of summation: a numpy emulation
  (``utils.testing.onepass_emulate``) adds the plain versions' per-factor
  terms (``ck._TERMS``) in the kernel's order, one float32 add at a time
  (the 2 lanes of a thread, the reduce-scatter, the 8 warps, the tiles'
  lane chains, read in batches of 8 as ``add_tiles`` reads them in both
  finishes, and the butterfly). Trailing zero lanes must change no bit, a
  problem inside a ragged batch must give the bits it gives alone, and the
  sum must lie within N u sum|terms| of the float64 sum (u = 2^-24, the
  bound of any order of N float32 additions). maha3c has no mask row, and
  reproj gates points closer than its minimum depth: their masked, gated
  and zero lanes must add nothing either;
- the buffers bound for the kernel: ``lane_aligned`` gives rows that start
  every ld floats, ld % 4 == 0, zero past N, for the 16-, 10- and 6-row
  layouts, the packers apply it to CUDA buffers only, and the wrapper's
  layout check refuses any other layout.

Besides, the host side: every C function the kernel files export has its
ctypes signature, and the workspace is one per stream for eager calls and
one per call under CUDA-graph capture.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import nonlinear_optimizer_for_slam_tpu_torch as port
from nonlinear_optimizer_for_slam_tpu_torch.core import lie
from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck
from nonlinear_optimizer_for_slam_tpu_torch.ops.mahalanobis import MahalanobisData
from nonlinear_optimizer_for_slam_tpu_torch.ops.point_to_plane import PointToPlaneData
from nonlinear_optimizer_for_slam_tpu_torch.ops.reprojection import (
    MIN_DEPTH,
    CameraIntrinsics,
    ReprojectionData,
)
from nonlinear_optimizer_for_slam_tpu_torch.utils import testing

CSRC = Path(port.__file__).resolve().parent / "csrc"
TILE = ck.ONE_PASS_TILE
U = 2.0**-24
_emulate = testing.onepass_emulate
_reduce_scatter = testing.onepass_reduce_scatter
_width = testing.onepass_scatter_width
_owner = testing.onepass_owner
SIZES_N = (0, 1, 3, 4, 1023, 1024, 1025, 2047, 8192, 8193, 18712, 18713, 1_000_003)
INTRINSICS = CameraIntrinsics.create(525.0, 525.0, 320.0, 240.0)

HARNESS = r"""
#include <cstdio>
#include <initializer_list>

#include "onepass.cuh"

using namespace nls::onepass;

int main() {
  std::printf("tile %d\n", kTile);
  std::printf("cluster_tiles %d\n", kClusterTiles);
  std::printf("finish_batch %d\n", kFinishBatch);
  std::printf("threads %d %d\n", kThreads, kWarps);
  const long long ns[] = {%NS%};
  for (long long n : ns) {
    std::printf("n %lld %lld %lld %lld\n", n, static_cast<long long>(num_tiles(n)),
                static_cast<long long>(workspace_floats(3, n, 28)),
                static_cast<long long>(workspace_floats(1, n, 10)));
    std::printf("cluster %lld %lld\n", n, static_cast<long long>(cluster_blocks(n)));
  }
  for (int k_out : {28, 10}) {
    const int w = scatter_width(k_out);
    std::printf("width %d %d\n", k_out, w);
    for (int k = 0; k < k_out; ++k) std::printf("owner %d %d %d\n", k_out, k, owner(k, w));
    for (int lane = 0; lane < 32; ++lane) {
      std::printf("held %d %d %d\n", k_out, lane, held_output(lane, w));
    }
  }
  for (int lane = 0; lane < 32; ++lane) {
    for (int off = 16; off > 0; off /= 2) {
      std::printf("upper %d %d %d\n", lane, off, keeps_upper(lane, off) ? 1 : 0);
    }
  }
  return 0;
}
"""


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tests run many tiny ops, which more
    threads only slow down, most of all when test workers share the
    machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def geometry(tmp_path_factory):
    """The header's geometry as the g++ harness prints it."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    tmp = tmp_path_factory.mktemp("onepass")
    src = tmp / "geometry.cc"
    src.write_text(HARNESS.replace("%NS%", ", ".join(f"{n}LL" for n in SIZES_N)))
    exe = tmp / "geometry"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-Wall", "-Werror", "-I", str(CSRC), "-o", str(exe), str(src)],
        check=True, capture_output=True, timeout=120,
    )
    lines = subprocess.run([str(exe)], check=True, capture_output=True, text=True, timeout=60)
    out = {"n": {}, "cluster": {}, "width": {}, "owner": {}, "held": {}, "upper": {}}
    for line in lines.stdout.splitlines():
        key, *vals = line.split()
        vals = [int(v) for v in vals]
        if key in ("tile", "cluster_tiles", "finish_batch"):
            out[key] = vals[0]
        elif key == "threads":
            out["threads"] = tuple(vals)
        elif key in ("n", "cluster"):
            out[key][vals[0]] = tuple(vals[1:])
        elif key == "width":
            out["width"][vals[0]] = vals[1]
        else:
            out[key][tuple(vals[:-1])] = vals[-1]
    return out


# ---------------------------------------------------------------------------
# geometry: the header against its Python copy and the simulation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES_N)
def test_geometry_matches_python_copy(geometry, n):
    assert geometry["tile"] == TILE
    assert geometry["threads"] == (testing.ONE_PASS_THREADS, testing.ONE_PASS_WARPS)
    tiles, ws6, ws3 = geometry["n"][n]
    assert tiles == ck.onepass_num_tiles(n) == -(-n // TILE)
    assert ws6 == ck.onepass_workspace_floats(3, n, 28) == 3 * tiles * 28
    assert ws3 == ck.onepass_workspace_floats(1, n, 10) == tiles * 10
    # every lane lies in exactly one tile
    assert tiles * TILE >= n and (tiles - 1) * TILE < max(n, 1)
    # the cluster finish: one block a tile up to 16 tiles (8,192 lanes), one
    # block for no lane
    assert geometry["cluster_tiles"] == ck.ONE_PASS_CLUSTER_TILES == 16
    (blocks,) = geometry["cluster"][n]
    assert blocks == ck.onepass_cluster_blocks(n) == (max(tiles, 1) if n <= 8192 else 0)
    # the finishing lanes' batch of reads, as the emulation reads them
    assert geometry["finish_batch"] == testing.ONE_PASS_FINISH_BATCH


@pytest.mark.parametrize("k_out", [28, 10], ids=["maha6", "maha3"])
def test_reduce_scatter_lands_each_output_on_its_owner(geometry, k_out):
    """Lane l starts with value (k + 1) 2^l for output k: after the
    simulated reduce-scatter, owner(k) holds (k + 1)(2^32 - 1) exactly, and
    every lane holds the output that held_output names."""
    width = geometry["width"][k_out]
    assert width == _width(k_out) == {28: 32, 10: 16}[k_out]
    for lane in range(32):
        for off in (16, 8, 4, 2, 1):
            assert geometry["upper"][(lane, off)] == int(bool(lane & off))
    v = np.zeros((32, width), np.float64)
    v[:, :k_out] = np.arange(1, k_out + 1)[None, :] * 2.0 ** np.arange(32)[:, None]
    held = _reduce_scatter(v)
    full = 2.0**32 - 1.0
    for k in range(k_out):
        assert geometry["owner"][(k_out, k)] == _owner(k, width)
        assert held[geometry["owner"][(k_out, k)]] == (k + 1) * full
    for lane in range(32):
        k = geometry["held"][(k_out, lane)]
        assert held[lane] == (k + 1) * full or k >= k_out


# ---------------------------------------------------------------------------
# the order of summation
# ---------------------------------------------------------------------------

LOSSES = [port.TrivialLoss(), port.ExponentialLoss(1.0, 1.0), port.HuberLoss(1.0)]
ALL_LOSSES = LOSSES + [
    port.CauchyLoss(1.5), port.TukeyLoss(2.0), port.GemanMcClureLoss(1.2), port.DCSLoss(2.5),
]


def _maha_data(rng, n):
    """Random Mahalanobis data, about 10 % of it masked."""
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    return MahalanobisData(
        f32(rng.normal(size=(n, 3))), f32(rng.normal(size=(n, 3))),
        f32(rng.normal(size=(n, 3, 3))), f32(rng.uniform(size=n) > 0.1),
    )


def _reproj_data(rng, n):
    """Points around z = 4, a tenth of them near or behind the 0.03 depth
    gate, pixels in a 640 x 480 image, about 10 % masked."""
    X = rng.normal(size=(n, 3)) + np.array([0.0, 0.0, 4.0])
    X[: n // 10, 2] = rng.uniform(-1.0, 0.1, size=n // 10)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    return ReprojectionData(
        f32(X), f32(rng.uniform(0.0, 640.0, size=(n, 2))), f32(rng.uniform(size=n) > 0.1)
    )


def _problem(rng, n, kernel="maha6"):
    """(rows, n) float32 of ``kernel``'s packing, about 10 % masked: maha3c's
    rows packed from Mahalanobis data (its mask folded into the Gram rows),
    reproj's from points on both sides of its depth gate, the others random
    rows with the mask in the last row."""
    if kernel == "maha3c":
        return ck.pack_maha3_compact(_maha_data(rng, n))
    if kernel == "reproj":
        return ck.pack_reproj(_reproj_data(rng, n))
    rows = ck._SHAPES[kernel][0]
    packed = rng.normal(size=(rows, n)).astype(np.float32)
    packed[rows - 1] = (rng.uniform(size=n) > 0.1).astype(np.float32)
    return torch.as_tensor(packed)


def _small_rotations(rng, batch):
    """(batch, 3, 3) float32 rotations within about 0.2 rad of the identity,
    which keep reproj's points in front of the camera."""
    q = np.concatenate([np.ones((batch, 1)), 0.1 * rng.normal(size=(batch, 3))], axis=1)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return lie.quat_to_rotmat(torch.as_tensor(q, dtype=torch.float32))


def _params(kernel, rng, batch, loss):
    if kernel == "reproj":
        code, loss_ab = ck.reproj_loss_ab(loss, "cpu")
        t = torch.as_tensor(0.1 * rng.normal(size=(batch, 3)), dtype=torch.float32)
        return code, ck.reproj_params(_small_rotations(rng, batch), t, INTRINSICS, loss_ab)
    code, loss_ab = ck.maha6_loss_ab(loss, "cpu")
    if kernel in ("maha3", "maha3c"):
        theta = torch.as_tensor(rng.uniform(-np.pi, np.pi, size=batch), dtype=torch.float32)
        t2 = torch.as_tensor(rng.normal(size=(batch, 2)), dtype=torch.float32)
        return code, ck.maha3_params(lie.rot2(theta), t2, loss_ab)
    q = rng.normal(size=(batch, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    R = lie.quat_to_rotmat(torch.as_tensor(q, dtype=torch.float32))
    t = torch.as_tensor(rng.normal(size=(batch, 3)), dtype=torch.float32)
    return code, ck.maha6_params(R, t, loss_ab)


def _terms(kernel, params, packed, code):
    return ck._TERMS[kernel](params, packed, code).numpy()  # (B, K, N)


@pytest.mark.parametrize("loss", LOSSES, ids=lambda l: type(l).__name__)
@pytest.mark.parametrize("kernel", ck.ONE_PASS)
def test_trailing_zero_lanes_change_no_bit(rng, kernel, loss):
    n = 2500
    packed = _problem(rng, n, kernel)
    code, params = _params(kernel, rng, 1, loss)
    want = _emulate(_terms(kernel, params, packed[None], code)[0])
    for zeros in (1, 3, TILE - n % TILE, TILE + 5, 3 * TILE):
        padded = torch.nn.functional.pad(packed, (0, zeros))
        got = _emulate(_terms(kernel, params, padded[None], code)[0])
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("loss", LOSSES, ids=lambda l: type(l).__name__)
@pytest.mark.parametrize("kernel", ck.ONE_PASS)
def test_ragged_batch_lane_sums_as_alone(rng, kernel, loss):
    """Problems of 5,000, 1,025 and 3 lanes in one zero-padded batch: each
    problem's sum has the bits of the same terms summed alone at its N."""
    sizes = (5000, 1025, 3)
    buf = torch.zeros((len(sizes), ck._SHAPES[kernel][0], max(sizes)))
    for b, n in enumerate(sizes):
        buf[b, :, :n] = _problem(rng, n, kernel)
    code, params = _params(kernel, rng, len(sizes), loss)
    terms = _terms(kernel, params, buf, code)
    for b, n in enumerate(sizes):
        in_batch = _emulate(terms[b])
        alone = _emulate(np.ascontiguousarray(terms[b, :, :n]))
        np.testing.assert_array_equal(in_batch.view(np.uint32), alone.view(np.uint32))


@pytest.mark.parametrize("loss", ALL_LOSSES, ids=lambda l: type(l).__name__)
def test_maha3c_masked_and_zero_lanes_add_nothing(rng, loss):
    """maha3c has no mask row. A masked factor of the real packing has M, v
    and szz of +0 or -0 (a negative M01 times a mask of 0 is -0), and a zero
    lane below N (the planar minimizer pads its correspondences to a
    multiple of 1,024) has every row 0. Both give |r|^2 = +0, so the cost
    rho(0) is +0 for all 7 losses, and every other term is +0 or -0. As the
    kernel's sums start at +0, such terms leave every bit: the emulated sum
    is the same with them replaced by +0 or by -0."""
    n = 1500
    data = _maha_data(rng, n)
    packed = torch.nn.functional.pad(ck.pack_maha3_compact(data), (0, 2 * TILE + 7))
    code, params = _params("maha3c", rng, 1, loss)
    terms = _terms("maha3c", params, packed[None], code)[0]
    empty = np.concatenate([
        np.flatnonzero(data.mask.numpy() == 0), np.arange(n, packed.shape[-1])
    ])
    assert (terms[:, empty] == 0).all()
    assert not np.signbit(terms[9, empty]).any()  # rho(0) = +0
    assert np.signbit(terms[:, empty]).any()  # the -0 products occur
    want = _emulate(terms)
    for zero in (0.0, -0.0):
        swapped = terms.copy()
        swapped[:, empty] = np.float32(zero)
        np.testing.assert_array_equal(_emulate(swapped).view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("loss", ALL_LOSSES, ids=lambda l: type(l).__name__)
def test_reproj_gated_masked_and_zero_lanes_add_nothing(rng, loss):
    """reproj at t = 0, where the PnP minimizer starts: a point behind the
    0.03 depth gate, a masked one and a zero lane of the padding (X = 0, so
    Xw = t = 0, gated, with 1 / z taken at z = 1) all get weight and cost
    +0, so every term is +0 or -0 (a +0 weight times a negative Jacobian
    product is -0) and the cost +0, for all 7 losses. As the kernel's sums
    start at +0, such terms leave every bit: the emulated sum is the same
    with them replaced by +0 or by -0."""
    n = 1500
    data = _reproj_data(rng, n)
    packed = torch.nn.functional.pad(ck.pack_reproj(data), (0, 2 * TILE + 7))
    code, loss_ab = ck.reproj_loss_ab(loss, "cpu")
    R = _small_rotations(rng, 1)
    params = ck.reproj_params(R, torch.zeros((1, 3)), INTRINSICS, loss_ab)
    terms = _terms("reproj", params, packed[None], code)[0]
    depth = R[0, 2].numpy() @ packed[:3].numpy()
    empty = np.flatnonzero((depth < MIN_DEPTH) | (packed[5].numpy() == 0))
    assert np.isin(np.arange(n, packed.shape[-1]), empty).all()  # the padding
    assert (depth[:n] < MIN_DEPTH).sum() > 50 and (data.mask.numpy() == 0).sum() > 50
    assert (terms[:, empty] == 0).all()
    assert not np.signbit(terms[27, empty]).any()  # the cost: +0
    assert np.signbit(terms[:, empty]).any()  # the -0 products occur
    want = _emulate(terms)
    for zero in (0.0, -0.0):
        swapped = terms.copy()
        swapped[:, empty] = np.float32(zero)
        np.testing.assert_array_equal(_emulate(swapped).view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n", [1, 1023, 4097])
@pytest.mark.parametrize("kernel", ck.ONE_PASS)
def test_sum_within_float32_bound_of_f64(rng, kernel, n):
    packed = _problem(rng, n, kernel)
    code, params = _params(kernel, rng, 1, port.ExponentialLoss(1.0, 1.0))
    terms = _terms(kernel, params, packed[None], code)[0]
    got = _emulate(terms).astype(np.float64)
    exact = terms.astype(np.float64).sum(axis=1)
    bound = n * U * np.abs(terms).astype(np.float64).sum(axis=1)
    assert (np.abs(got - exact) <= bound).all(), (np.abs(got - exact) / bound).max()
    # the plain version sums in another order, within the same bound
    plain = ck._TERMS[kernel](params, packed[None], code).sum(dim=-1)[0].numpy()
    assert (np.abs(plain.astype(np.float64) - exact) <= bound).all()


# ---------------------------------------------------------------------------
# the buffers bound for the kernel
# ---------------------------------------------------------------------------


def _full_rows(view: torch.Tensor) -> torch.Tensor:
    """The whole rows, ld floats each, under a lane_aligned view."""
    ld = view.stride(-2)
    return torch.as_strided(view, view.shape[:-1] + (ld,), view.stride(), view.storage_offset())


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1023, 1025, 18713])
def test_lane_aligned_rows(rng, n):
    """The 16-row layout (maha6, maha3), the 10-row one (maha3c, p2p) and
    the 6-row one (reproj)."""
    for kernel, rows in (("maha6", 16), ("p2p", 10), ("reproj", 6)):
        packed = torch.as_tensor(rng.normal(size=(3, rows, n)), dtype=torch.float32)
        packed[:, rows - 1] = 1.0  # the mask row: its padding must be zero too
        out = ck.lane_aligned(packed)
        assert out.shape == packed.shape and torch.equal(out, packed)
        one = ck.lane_aligned(packed[0])  # a single (rows, N) buffer, as a packer makes it
        assert one.shape == (rows, n) and torch.equal(one, packed[0])
        if n % 4 == 0:  # already aligned: no copy
            assert out.data_ptr() == packed.data_ptr()
        if n == 0:
            continue
        ld = out.stride(1)
        assert ld == -(-n // 4) * 4 and ld % ck.LANE_ALIGN == 0
        assert out.stride() == (rows * ld, ld, 1) and out.data_ptr() % 16 == 0
        assert ck._one_pass_ld(kernel, out) == ld
        assert not _full_rows(out)[..., n:].any()
        assert one.stride() == (ld, 1)
        assert ck._one_pass_ld(kernel, one[None]) == ld


def test_packers_align_only_kernel_buffers(rng):
    """pack_maha6, pack_maha3_compact, pack_reproj and pack_p2p on the CPU
    keep their contiguous (rows, N) buffers, bit for bit the lane_aligned
    views' values."""
    n = 1023
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    maha = _maha_data(rng, n)
    p2p = PointToPlaneData(
        f32(rng.normal(size=(n, 3))), f32(rng.normal(size=(n, 3))),
        f32(rng.normal(size=(n, 3))), f32(rng.uniform(size=n) > 0.1),
    )
    for packed, rows in (
        (ck.pack_maha6(maha), 16), (ck.pack_maha3_compact(maha), 10), (ck.pack_p2p(p2p), 10),
        (ck.pack_reproj(_reproj_data(rng, n)), 6),
    ):
        assert packed.shape == (rows, n) and packed.is_contiguous()
        aligned = ck.lane_aligned(packed)
        assert torch.equal(aligned, packed) and aligned.stride(0) == 1024


def _misaligned(kind, rows=16):
    buf = torch.zeros((2, rows, 1028))
    return {
        "ld_not_multiple_of_4": torch.zeros((2, rows, 1023)),
        "unaligned_start": buf[..., 1:1024],
        "transposed_rows": torch.zeros((2, 1024, rows)).transpose(1, 2),
        "problems_not_rows_ld_apart": torch.zeros((2, rows + 1, 1024))[:, :rows],
        # the last row's last 16 bytes would end 2 floats past the storage
        "storage_too_short": torch.as_strided(
            torch.zeros(rows * 1024 - 2), (1, rows, 1021), (rows * 1024, 1024, 1)
        ),
    }[kind]


@pytest.mark.parametrize("kind", [
    "ld_not_multiple_of_4", "unaligned_start", "transposed_rows",
    "problems_not_rows_ld_apart", "storage_too_short",
])
def test_kernel_layout_check_refuses(kind):
    """For every kernel, at its rows (16, 10 or 6)."""
    for kernel in ck.ONE_PASS:
        rows = ck._SHAPES[kernel][0]
        with pytest.raises(ValueError, match="lane_aligned"):
            ck._one_pass_ld(kernel, _misaligned(kind, rows))
        # the same buffer laid out by lane_aligned passes
        assert ck._one_pass_ld(kernel, ck.lane_aligned(_misaligned(kind, rows))) % 4 == 0


# ---------------------------------------------------------------------------
# the host side: C signatures and the workspace
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["maha6", "maha3", "maha3c", "reproj", "p2p"])
def test_every_c_export_has_its_signature(kernel):
    """Each C function a kernel's library exports (its file's, and
    onepass.cuh's, which every kernel file includes) is typed by the
    wrappers' table, with as many arguments as the source declares."""
    src = (CSRC / f"{kernel}.cu").read_text() + (CSRC / "onepass.cuh").read_text()
    exports = {
        name: len([a for a in args.split(",") if a.strip()])
        for name, args in re.findall(r"^int (nls_\w+)\(([^)]*)\)", src, re.M)
    }
    assert f"nls_{kernel}_launch" in exports
    for name, n_args in exports.items():
        argtypes, restype = ck._SIGNATURES[name]
        assert len(argtypes) == n_args and restype is ctypes.c_int, name


def test_every_signature_names_an_export():
    exported = set()
    for src in [*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]:
        exported |= set(re.findall(r"^int (nls_\w+)\(", src.read_text(), re.M))
    assert set(ck._SIGNATURES) == exported


@pytest.mark.parametrize("capturing", [False, True], ids=["eager", "graph_capture"])
def test_workspace_per_stream_or_per_capture(monkeypatch, capturing):
    """Eager calls on one stream share a cached workspace, grown when a call
    needs more; a call under CUDA-graph capture gets a fresh one, counters
    zero, and leaves the eager cache alone."""
    monkeypatch.setattr(ck, "_WORKSPACE", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    a = ck._workspace("maha6", "cpu", 0, 7, 56, 2)
    b = ck._workspace("maha6", "cpu", 0, 7, 28, 1)
    for sums, counters in (a, b):
        assert sums.dtype == torch.float32 and counters.dtype == torch.int32
        assert not counters.any()
    assert a[0].numel() >= 56 and a[1].numel() >= 2
    if capturing:
        assert ck._WORKSPACE == {}
        assert a[0].data_ptr() != b[0].data_ptr() and a[1].data_ptr() != b[1].data_ptr()
        return
    assert b is a  # the same stream's smaller call reuses it
    assert ck._workspace("maha6", "cpu", 0, 8, 56, 2) is not a  # another stream
    grown = ck._workspace("maha6", "cpu", 0, 7, 60, 3)
    assert grown[0].numel() >= 2 * 56 and grown[1].numel() >= 2 * 2
    assert ck._WORKSPACE[("maha6", 0, 7)] is grown

