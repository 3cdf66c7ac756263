"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (maha6, maha3, maha3c, reproj, p2p, and the
bf16-row instantiations of maha6 and maha3) from the
sources in this checkout, holds each kernel against its plain PyTorch
version on the card, and drives the port's main paths through the kernels:
on the full room fixture the host-driven 6-DoF NDT registration
(``register_ndt``), the device-resident ``NdtRegistrar`` (6-DoF, planar,
point-to-plane and a lockstep batch of 16 scans) and the planar 3-DoF
minimizer under ``register_ndt``; on the reference's PnP fixture the
reprojection minimizer. Then the serving paths: each kernel at their
batched shapes, lane by lane, against its plain version; the batched
solvers (maha at B = 16, PnP at B = 256, p2p at B = 16; one kernel launch
per batched LM iteration, every instance's count equal to its serial
solve's and to the plain path's), the registrar's vmap batch mode beside
lockstep and the plain registrar at B = 4, the registrar's blocks replayed
from CUDA graphs against its eager blocks (bit for bit, with equal counts,
timed in turns, and K swept at B = 16), D2D registration
(host loop and ``D2dRegistrar``) and loop closure. All five are one-launch kernels on
``csrc/onepass.cuh``; each is also held to its plain version at edge sizes
of N, over 1,000 launches that alternate between two shapes, on a second
stream, replayed from CUDA graphs (two of them at once on two streams,
beside eager calls), with the cluster finish (up to 16 tiles) against the
ticket's on the same problem zero-padded past 16 tiles, and timed against
an empty kernel's launch. It checks the f64
path against the reference oracle traces, and times the kernels and the
paths. Last, the SE(3) pose graph in float64, which runs plain PyTorch
ops and no port kernel: the reference's 80-pose fixture by every solver
(dense, tridiag, banded, cg, auto) against dense and the scipy oracle,
sphere2500 through the g2o writer and reader and solver="auto" (banded)
against dense at 17,500 unknowns, and the 5,000-pose chain (tridiag),
with the 2,000-pose chain by tridiag against dense. Then the sparse
multifrontal solver, the SE(2) optimizer and the chordal initializer, in
float64 and with no port kernel either: the 80-pose fixture by sparse
against dense (two sparse solves bitwise equal), sphere2500 by sparse
against banded, M3500 (3,500 SE(2) poses) through the g2o writer and
reader, ``initialize(method="chordal")`` and solver="auto" (sparse)
against banded and dense from the same start, and the 10,000-pose city
(auto: sparse) timed beside banded under a cap of LM iterations; ATE and
RPE of the sphere2500 and M3500 solutions (``utils/evaluation.py``). Then
the marginal covariances (the fixture, sphere2500, M3500 and the city by
auto, banded and the multifrontal selected inverse against dense, the
city against sparse) and the batched solves (the fixture at B = 256 with
resampled measurements, 16 lanes against their serial solves; a 500-pose
SE(2) world at B = 32; the Monte-Carlo ring at B = 768 against
``covariance()``; a probe of the lone and batched 564-row factor), in
float64 and with no port kernel. Last, the generic ``PoseOptimizer``
(float64, the maha-simple correspondences with two priors, and a hand-eye
problem) against the same solves on the CPU; two ranks spawned on the one
card over gloo (host-staged partials) running every ``mesh=`` path (the
four minimizers and the registrar through their kernels, CG and sparse)
against the unsharded calls, with a one-rank NCCL group's maha6 solve
bitwise the unsharded one; and ``utils.time_checker``'s ``device_time``
and ``trace``. Then the native host pipeline (``native.py``: its g++ build
timed from an empty ``build/torch_native/``, the C++ map builder and
voxel filter against the numpy copy on the room), ``HybridRegistrar``
(native matching on the host, the maha6 and planar maha3 LM on the card,
one launch per LM evaluation) beside ``register_ndt`` and the
``NdtRegistrar``, ``examples/full_slam.py`` at its defaults with its
fixed-lag smoother's updates replayed on the CPU port, ``fixed_lag_slam``
blocking and streaming, and every other example as a subprocess on the
card (``bal_solve`` among them). Last, slice 13, in plain PyTorch ops with
no port kernel: ``BundleAdjuster`` on benchmarks/run_all.py's rigs (8
cameras and 300 landmarks in float32 and float64, float64 against the CPU
port; 100 cameras and 10,000 landmarks grouped and flat), ``solve_bal`` on
its synthetic BAL shapes from 49-7776 to the final/13682 shape (dense,
chunked and iterative Schur; float64 against the CPU port), and the
pose-landmark optimizers on its 3-D world (dense and sparse against each
other and the CPU port), city (sparse, with sparse covariances) and 2-D
world; the two-rank ``sharded`` phase also runs ``BundleAdjuster(mesh=)``.
Then the bf16-row instantiations of maha6 and maha3 (phase
``bf16_rows``: each against its plain version and bit for bit the float32
kernel on the widened rows, on the phase-2 cases, the edge N and zero
padding; its main path, run_all.py's 40-iteration rate solve on the
fixture's bf16 rows, launches counted; float32 against bf16 rows timed in
turns), then, with no port kernel, the GPS-INS batch
(``InertialGraphOptimizer``, 500 keyframes of 200 Hz IMU and GPS, float64,
8,000 unknowns; 41 keyframes against the CPU port), the online
``FixedLagInertialSmoother`` (lag 10, 200 keyframes, blocking and
``update_async`` every 4), the Sim(3) essential graph (run_all.py's 200
keyframes with 52x scale drift, float32 with the float64 polish on the card
and float64, against the scipy optimum) and a 2,000-keyframe drifting chain
through ``solver="auto"`` (sparse); ``gps_ins`` runs in the examples phase.
Every phase prints one JSON line; a phase that fails ends the run with a
non-zero exit code.
The line before the last is the ``kernels`` summary, the last line
``{"ok": true, "device": {...}}``.

It needs a CUDA device and exits non-zero without one. It imports nothing
of the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

SEED = 0
REPO = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet) at its 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12  # float32 outside the tensor cores

# Per kernel: packed rows, outputs, and the float operations of one factor
# in csrc/factor_math.cuh, counted from the source.
# The exponential loss is 9 (-b sq, expm1, 1 +, the select of
# exp_rounded, a exp, a -, 2 a b exp).
# maha6: e = R p + t - mu (21), r = S e (15), |r|^2 (5), loss (9), mask
# (2), B = S R (45), the Jacobian's cross products (27), 21 H terms x 7
# (147), 6 g terms x 7 (42), cost (1).
# maha3: the xy warp (8), e (3), r = S e (15), |r|^2 (5), loss (9), mask
# (2), R2 (-p_y, p_x) (6), the yaw column (9), 6 H x 7 (42), 3 g x 7
# (21), cost (1).
# maha3c: e (10), M e (6), the quadratic form and its clamp (10), loss
# (9), rs = R2 (-u_y, u_x) (8), M rs (6), M e + v (2), 5 H terms x 2 (10),
# H22 (5), g0 and g1 x 2 (4), g2 (5), cost (1).
# reproj: Xw = R X + t (18), the gate (3), 1/z and 1/z^2 (2), r (10),
# |r|^2 (3), loss (9), mask (3), dpi/dXw (4), the columns of R skew(X)
# (27), the rotation part of J (24), 21 H x 5 (105), 6 g x 5 (30), cost (1).
# p2p: e (21), r = n.e (5), r^2 (1), loss (9), mask (2), the columns of
# R skew(p) (27), their dots with n (18), 21 H x 3 (63), 6 g x 3 (18),
# cost (1).
KERNEL_SHAPE = {
    "maha6": (16, 28, 314),
    "maha3": (16, 10, 121),
    "maha3c": (10, 10, 76),
    "reproj": (6, 28, 239),
    "p2p": (10, 28, 165),
}
TPU_KERNEL = {
    "maha6": "nonlinear_optimizer_for_slam_tpu/ops/pallas_kernels.py:202",
    "maha3": "nonlinear_optimizer_for_slam_tpu/ops/pallas_kernels.py:438",
    "maha3c": "nonlinear_optimizer_for_slam_tpu/ops/pallas_kernels.py:670",
    "reproj": "nonlinear_optimizer_for_slam_tpu/ops/pallas_kernels.py:791",
    "p2p": "nonlinear_optimizer_for_slam_tpu/ops/pallas_kernels.py:954",
}

# Warm runs a median of the descriptive walls takes (20 before the inertial
# and Sim(3) phases came; cut to 10 when they took the whole run near its
# time limit: the medians move by less than the host's drift between
# calls).
TIMING_RUNS = 10

# Kernel vs plain version: the two sum in different orders (registers, warp
# shuffles and tile sums against PyTorch's reductions) and nvcc
# contracts to FMAs, so each output may differ by a few float32 roundings
# of the terms it sums: |kernel - plain| <= RTOL * scale + ATOL, with scale
# the sum of |terms| (see _error_scale for the off-diagonal H entries).
RTOL = 1e-4
ATOL = 1e-6

# Start of the point-to-plane registration: 5 cm above the identity. From
# the identity every floor point lies exactly trim_distance (0.3 m, the
# true pose's height) from the floor plane, where the last bit of the
# arithmetic decides whether it is trimmed.
P2P_START_T = (0.0, 0.0, 0.05)


_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase line, with the seconds since the script started (``t_s``):
    where the run's time goes, phase by phase."""
    t_s = round(time.perf_counter() - _START, 1)
    print(json.dumps({"phase": phase, **fields, "t_s": t_s}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import nonlinear_optimizer_for_slam_tpu_torch as port
    from nonlinear_optimizer_for_slam_tpu_torch.core import lie
    from nonlinear_optimizer_for_slam_tpu_torch.ops import _build, cuda_kernels as ck
    from nonlinear_optimizer_for_slam_tpu_torch.ops import mahalanobis, reprojection
    from nonlinear_optimizer_for_slam_tpu_torch.pipelines import matching, ndt
    from nonlinear_optimizer_for_slam_tpu_torch.utils import testing

    dev = torch.device("cuda")

    # ---- 1. device --------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    emit(
        "device", name=name, nvidia_smi=smi, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        build_s=build_s, ptxas={k: _ptxas_summary(v) for k, v in logs.items()},
    )

    # ---- the fixture (shared by every phase) ------------------------------
    t0 = time.perf_counter()
    pts = testing.generate_room_points()
    t1 = time.perf_counter()
    ndt_map = ndt.build_ndt_map(pts, 1.0)
    t2 = time.perf_counter()
    p2p_map = ndt.build_ndt_map(pts, 1.0, identity_moment=False)
    t3 = time.perf_counter()
    scan = ndt.filter_points(pts, 0.1)
    fixture_s = time.perf_counter() - t0
    # the numpy builder's times, beside the native ones (native_pipeline)
    numpy_s = {"build_ndt_map_s": t2 - t1, "filter_points_s": fixture_s - (t3 - t0)}
    if pts.shape[0] != 954605 or int(ndt_map.valid.sum()) != 96 or scan.shape[0] != 9356:
        raise AssertionError((pts.shape, int(ndt_map.valid.sum()), scan.shape))
    true_pose = testing.maha_true_pose()
    local = true_pose.inverse().apply(scan)
    planar_pose = testing.maha_3dof6dof_true_pose()
    local_planar = planar_pose.inverse().apply(scan)
    p2p_start = port.Pose(np.eye(3), np.asarray(P2P_START_T))
    valid = ndt_map.valid_only()
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)
    ones = torch.ones(local.shape[0], device=dev)
    # the first outer iteration's correspondences: identity pose, radius 1, k 2
    matched = matching.match_point_cloud(
        f32(valid.means), f32(valid.sqrt_informations), f32(local), ones,
        torch.eye(3, device=dev), torch.zeros(3, device=dev),
    )
    fixture_packed = ck.pack_maha6(matched)  # (16, 18712)
    main_packed = ck.pack_maha6(matched.pad_to(19456))  # slice 1's padded buffer
    # the planar minimizer's first correspondences, in its compact packing
    planar_matched = matching.match_point_cloud(
        f32(valid.means), f32(valid.sqrt_informations), f32(local_planar), ones,
        torch.eye(3, device=dev), torch.zeros(3, device=dev),
    )
    planar_packed = ck.pack_maha3_compact(planar_matched)  # (10, 18712)
    # the reference's PnP fixture: 630 correspondences, 640 x 480 pinhole
    r_pts, r_pix, intrinsics, reproj_truth = testing.generate_reprojection_fixture()
    reproj_data = reprojection.ReprojectionData(
        f32(r_pts), f32(r_pix), torch.ones(r_pts.shape[0], device=dev)
    )
    reproj_packed = ck.pack_reproj(reproj_data)  # (6, 630)
    m = port.pipelines.fused_registration.build_map_state(
        p2p_map, "p2p", max_thickness=0.05, device=dev
    )
    p2p_matched = matching.match_point_to_plane(
        m.means_T.T, m.normals_T.T, m.voxel_weights, f32(local), ones,
        f32(p2p_start.rotation), f32(p2p_start.translation), num_neighbors=4,
    )
    p2p_packed = ck.pack_p2p(p2p_matched)  # (10, 9356)
    emit("fixture", points=int(pts.shape[0]), voxels=int(valid.means.shape[0]),
         scan=int(scan.shape[0]), correspondences=int(matched.num_factors),
         real=int(matched.mask.sum().item()),
         p2p_pairs=int(p2p_matched.num_factors), p2p_real=int(p2p_matched.mask.sum().item()),
         p2p_planes=int(m.voxel_weights.sum().item()),
         planar_correspondences=int(planar_matched.num_factors),
         reproj_correspondences=int(reproj_data.num_factors), build_s=fixture_s)

    # ---- 2. each kernel against its plain version on the card --------------
    rng = np.random.default_rng(SEED)
    losses = [
        port.TrivialLoss(),
        port.ExponentialLoss(1.0, 1.0),
        port.HuberLoss(1.0),
        port.CauchyLoss(1.5),
        port.TukeyLoss(2.0),
        port.GemanMcClureLoss(1.2),
        port.DCSLoss(2.5),
    ]
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    rand_pose = port.Pose.from_quat_trans(q, rng.normal(size=3) * 0.1)
    identity = port.Pose.identity()

    def random_packed(kernel: str, n: int) -> "torch.Tensor":
        """Random rows of ``kernel``'s packing, about 10 % of them masked.
        maha3c folds the mask into its Gram rows, so its rows are packed
        from random Mahalanobis data; reproj's points lie around z = 4, a
        tenth of them near or behind the 0.03 depth gate."""
        mask = (rng.uniform(size=n) > 0.1).astype(np.float32)
        if kernel == "maha3c":
            data = mahalanobis.MahalanobisData(
                f32(rng.normal(size=(n, 3))), f32(rng.normal(size=(n, 3))),
                f32(rng.normal(size=(n, 3, 3))), f32(mask),
            )
            return ck.pack_maha3_compact(data)
        if kernel == "reproj":
            X = rng.normal(size=(n, 3)) + np.array([0.0, 0.0, 4.0])
            X[: n // 10, 2] = rng.uniform(-1.0, 0.1, size=n // 10)
            data = reprojection.ReprojectionData(
                f32(X), f32(rng.uniform(0.0, 640.0, size=(n, 2))), f32(mask)
            )
            return ck.pack_reproj(data)
        rows = KERNEL_SHAPE[kernel][0]
        out = rng.normal(size=(rows, n)).astype(np.float32)
        out[rows - 1] = mask  # the mask row
        return torch.as_tensor(out, device=dev)

    def batch3(kernel: str) -> "torch.Tensor":
        sizes = [1_000_003, 18_712, 5_000]
        out = torch.zeros((3, KERNEL_SHAPE[kernel][0], max(sizes)), device=dev)
        for b, n in enumerate(sizes):
            out[b, :, :n] = random_packed(kernel, n)
        return ck.lane_aligned(out)

    def params_of(kernel, poses, loss):
        """(loss code, (B, params) float32) at the given poses; maha3 and
        maha3c take each pose's yaw and planar translation, reproj the
        fixture's intrinsics."""
        if kernel == "reproj":
            code, loss_ab = ck.reproj_loss_ab(loss, dev)
            R = torch.stack([f32(p.rotation) for p in poses])
            t = torch.stack([f32(p.translation) for p in poses])
            return code, ck.reproj_params(R, t, intrinsics, loss_ab).contiguous()
        code, loss_ab = ck.maha6_loss_ab(loss, dev)
        if kernel in ("maha3", "maha3c"):
            theta = torch.tensor(
                [2.0 * np.arctan2(p.quaternion()[3], p.quaternion()[0]) for p in poses],
                device=dev,
            )
            t2 = torch.stack([f32(p.translation[:2]) for p in poses])
            return code, ck.maha3_params(lie.rot2(theta), t2, loss_ab).contiguous()
        R = torch.stack([f32(p.rotation) for p in poses])
        t = torch.stack([f32(p.translation) for p in poses])
        return code, ck.maha6_params(R, t, loss_ab).contiguous()

    partials = {k: getattr(ck, f"{k}_partials") for k in KERNEL_SHAPE}
    terms = {k: getattr(ck, f"{k}_terms") for k in KERNEL_SHAPE}
    cases = {
        "maha6": {
            "fixture_n18712": (fixture_packed[None], [identity]),
            "main_path_n19456": (main_packed[None], [identity]),
        },
        "maha3": {"fixture_n18712": (fixture_packed[None], [identity])},
        "maha3c": {"fixture_n18712": (planar_packed[None], [identity])},
        "reproj": {"fixture_n630": (reproj_packed[None], [identity])},
        "p2p": {"fixture_n9356": (p2p_packed[None], [p2p_start])},
    }
    main_case = {
        "maha6": "fixture_n18712", "maha3": "fixture_n18712", "maha3c": "fixture_n18712",
        "reproj": "fixture_n630", "p2p": "fixture_n9356",
    }
    worst = {}
    for kernel, kcases in cases.items():
        kcases["ragged_n1000003"] = (
            ck.lane_aligned(random_packed(kernel, 1_000_003)[None]), [rand_pose]
        )
        kcases["batch3"] = (batch3(kernel), [rand_pose, identity, rand_pose.inverse()])
        report = {}
        for case, (packed, poses) in kcases.items():
            for loss in losses:
                code, params = params_of(kernel, poses, loss)
                got = partials[kernel](params, packed, code)
                again = partials[kernel](params, packed, code)
                torch.cuda.synchronize()
                label = f"{kernel} {case} {type(loss).__name__}"
                if not torch.equal(got, again):
                    raise AssertionError(f"{label}: two runs differ")
                all_terms = terms[kernel](params, packed, code)
                want, scale = all_terms.sum(dim=-1), _error_scale(all_terms)
                if not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"{label}: non-finite output")
                err = (got - want).abs()
                bad = err > RTOL * scale + ATOL
                if bool(bad.any()):
                    raise AssertionError(
                        f"{label}: kernel vs plain at (problem, output) "
                        f"{bad.nonzero()[:4].tolist()}: kernel {got[bad][:4].tolist()}, "
                        f"plain {want[bad][:4].tolist()}, scale {scale[bad][:4].tolist()}"
                    )
                rel = (err / (scale + ATOL)).max().item()
                worst[(kernel, case, type(loss).__name__)] = err.max().item()
                report[f"{case}/{type(loss).__name__}"] = {
                    "max_abs_err": err.max().item(), "max_rel_err": rel,
                }
        # trailing zero lanes (a ragged batch's padding) change no bit
        packed, poses = kcases[main_case[kernel]]
        code, params = params_of(kernel, poses, losses[1])
        padded = ck.lane_aligned(torch.nn.functional.pad(packed, (0, 4099)))
        if not torch.equal(partials[kernel](params, packed, code),
                           partials[kernel](params, padded, code)):
            raise AssertionError(f"{kernel}: zero padding changes the result")
        emit("kernel_vs_plain", kernel=kernel, rtol_of_abs_sum=RTOL, atol=ATOL,
             bitwise_repeatable=True, zero_padding_invariant=True, cases=report)

    # ---- 2b. the one-pass kernels: edge N, counters, streams, graphs -------
    def check_close(label, got, all_terms) -> float:
        """The kernel's output within the tolerance of phase 2 of its plain
        version; returns the largest error."""
        want, scale = all_terms.sum(dim=-1), _error_scale(all_terms)
        err = (got - want).abs()
        if not bool(torch.isfinite(got).all()) or bool((err > RTOL * scale + ATOL).any()):
            raise AssertionError(f"{label}: kernel {got.tolist()} vs plain {want.tolist()}")
        return err.max().item()

    def same_bits(a, b) -> bool:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    # a problem of ticket_n lanes (17 tiles) takes the ticket's finish; zero
    # lanes change no bit, so a problem zero-padded to ticket_n lanes holds
    # the cluster finish against the ticket's
    ticket_n = ck.ONE_PASS_CLUSTER_TILES * ck.ONE_PASS_TILE + 1

    def padded_to_ticket(packed):
        return ck.lane_aligned(
            torch.nn.functional.pad(packed, (0, ticket_n - packed.shape[-1]))
        )

    for kernel in ck.ONE_PASS:
        edge = {}
        for n in (0, 1, 3, 1023, 1025, 18713):
            packed = ck.lane_aligned(random_packed(kernel, n)[None])
            for loss_ in losses:
                code, params = params_of(kernel, [rand_pose], loss_)
                got = partials[kernel](params, packed, code)
                label = f"{kernel} n{n} {type(loss_).__name__}"
                if n == 0 and bool(got.any()):
                    raise AssertionError(f"{label}: {got.tolist()} for no factor")
                edge[f"n{n}/{type(loss_).__name__}"] = check_close(
                    label, got, terms[kernel](params, packed, code)
                )
        # the two finishes of onepass.cuh give the same bits: the cluster's
        # (up to 16 tiles) and the ticket's, on the problem zero-padded to
        # 17 tiles
        for n in (1, 1025, 4096, 8192):
            packed = ck.lane_aligned(random_packed(kernel, n)[None])
            code, params = params_of(kernel, [rand_pose], losses[1])
            by_cluster = partials[kernel](params, packed, code)
            by_ticket = partials[kernel](params, padded_to_ticket(packed), code)
            if ck.onepass_cluster_blocks(n) == 0 or ck.onepass_cluster_blocks(ticket_n) != 0:
                raise AssertionError(f"{kernel} n{n}: not one problem for each finish")
            if not same_bits(by_cluster, by_ticket):
                raise AssertionError(f"{kernel} n{n}: the two finishes differ")
        # a ragged batch of 3 through the cluster finish (clusters of 8
        # blocks, one a problem): each problem within tolerance of the plain
        # version, with the bits it has alone and, zero-padded, through the
        # ticket's finish
        sizes = (4096, 1025, 3)
        small = torch.zeros((3, KERNEL_SHAPE[kernel][0], max(sizes)), device=dev)
        for b, n in enumerate(sizes):
            small[b, :, :n] = random_packed(kernel, n)
        small = ck.lane_aligned(small)
        code, params_b3 = params_of(kernel, [rand_pose, identity, rand_pose.inverse()], losses[1])
        got = partials[kernel](params_b3, small, code)
        check_close(f"{kernel} small batch", got, terms[kernel](params_b3, small, code))
        alone = [
            partials[kernel](params_b3[b : b + 1], ck.lane_aligned(small[b : b + 1, :, :n]), code)
            for b, n in enumerate(sizes)
        ]
        by_ticket = partials[kernel](params_b3, padded_to_ticket(small), code)
        if not (same_bits(got, torch.cat(alone)) and same_bits(got, by_ticket)):
            raise AssertionError(f"{kernel}: a small batch through the cluster finish differs")
        # 1,000 launches alternating between two shapes: each equal to the
        # first of its shape, bit for bit (a counter left non-zero by one
        # launch would leave the next without a finishing block)
        (single, poses1), (triple, poses3) = cases[kernel][main_case[kernel]], cases[kernel]["batch3"]
        code, params1 = params_of(kernel, poses1, losses[1])
        _, params3 = params_of(kernel, poses3, losses[1])
        outs1, outs3 = [], []
        for _ in range(500):
            outs1.append(partials[kernel](params1, single, code))
            outs3.append(partials[kernel](params3, triple, code))
        r1, r3 = torch.stack(outs1), torch.stack(outs3)
        if not (same_bits(r1, r1[:1].expand_as(r1)) and same_bits(r3, r3[:1].expand_as(r3))):
            raise AssertionError(f"{kernel}: 1,000 alternating launches are not all equal")
        # a second stream, running the batch beside the default stream's
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            on_side = [partials[kernel](params3, triple, code) for _ in range(3)]
        on_main = [partials[kernel](params3, triple, code) for _ in range(3)]
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        if not all(same_bits(o, r3[0]) for o in on_side + on_main):
            raise AssertionError(f"{kernel}: a second stream changes the result")
        # CUDA graphs: one launch captured after a warm-up, replayed 10
        # times; then two graphs captured on one stream (B = 1 and the
        # ragged batch) replayed 100 times each at once on two streams,
        # while the capture stream runs the B = 1 call eagerly. Each
        # captured call has a workspace of its own, so no replay or eager
        # call takes another's tickets: every result keeps its eager bits.
        capture = torch.cuda.Stream()
        capture.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(capture):
            for _ in range(3):
                partials[kernel](params1, single, code)
                partials[kernel](params3, triple, code)
        torch.cuda.current_stream().wait_stream(capture)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=capture):
            captured = partials[kernel](params1, single, code)
        replays = []
        for _ in range(10):
            graph.replay()
            replays.append(captured.clone())
        torch.cuda.synchronize()
        if not all(same_bits(r, r1[0]) for r in replays):
            raise AssertionError(f"{kernel}: a graph replay differs from the eager call")
        graph3 = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph3, stream=capture):
            captured3 = partials[kernel](params3, triple, code)
        streams = (torch.cuda.Stream(), torch.cuda.Stream())
        for s in streams + (capture,):
            s.wait_stream(torch.cuda.current_stream())
        got1, got3, eager = [], [], []
        for _ in range(100):
            with torch.cuda.stream(streams[0]):
                graph.replay()
                got1.append(captured.clone())
            with torch.cuda.stream(streams[1]):
                graph3.replay()
                got3.append(captured3.clone())
            with torch.cuda.stream(capture):
                eager.append(partials[kernel](params1, single, code))
        for s in streams + (capture,):
            torch.cuda.current_stream().wait_stream(s)
        torch.cuda.synchronize()
        if not (all(same_bits(r, r1[0]) for r in got1 + eager)
                and all(same_bits(r, r3[0]) for r in got3)):
            raise AssertionError(
                f"{kernel}: two graphs replayed at once beside eager calls change a result"
            )
        del graph, graph3
        emit("onepass_checks", kernel=kernel, edge_n_max_abs_err=edge,
             alternating_launches=1000, alternating_bitwise_equal=True,
             finishes_bitwise_equal_at_n=[1, 1025, 4096, 8192], ticket_padded_to_n=ticket_n,
             cluster_batch_of_3_bitwise_as_alone=True,
             second_stream_bitwise_equal=True, graph_replays=10, graph_bitwise_equal=True,
             concurrent_graph_replays=200, concurrent_eager_calls=100,
             concurrent_bitwise_equal=True)

    # ---- 3. slice 1's main path: register_ndt through the maha6 kernel -----
    loss = port.ExponentialLoss(1.0, 1.0)
    minimizer = port.MahalanobisDistanceMinimizer(device="cuda").set_loss_function(loss)
    if minimizer.backend != "cuda" or minimizer.dtype != torch.float32:
        raise AssertionError((minimizer.backend, minimizer.dtype))

    def register():
        return port.register_ndt(ndt_map, local, identity, minimizer, port.Options())

    ck.reset_launches()
    res = register()
    launches = dict(ck.LAUNCHES)
    evaluations = _evaluations(res.summaries)
    if launches["maha6"] != evaluations or evaluations == 0:
        raise AssertionError(f"maha6 launches {launches['maha6']} != LM evaluations {evaluations}")
    t_err = float(np.linalg.norm(res.pose.translation - true_pose.translation))
    inner = [int(s.iterations) for s in res.summaries]
    final_cost = float(res.summaries[-1].final_cost)
    if not (t_err < 0.05 and np.isfinite(final_cost)):
        raise AssertionError(f"registration diverged: t_err {t_err}, cost {final_cost}")
    host_pose = res.pose
    emit(
        "main_path", outer=res.outer_iterations, inner=inner,
        lm_evaluations=evaluations, maha6_launches=launches["maha6"],
        t_err_mm=t_err * 1000.0, final_cost=final_cost,
        pose_t=res.pose.translation.tolist(), pose_q_wxyz=res.pose.quaternion().tolist(),
    )
    walls = _walls_ms(register, TIMING_RUNS)
    median_ms = statistics.median(walls)
    # the two layers of one outer iteration, timed alone: matching, and the
    # first inner LM solve (40 iterations) on its correspondences
    match_ms = _wall_ms(lambda: matching.match_point_cloud(
        f32(valid.means), f32(valid.sqrt_informations), f32(local), ones,
        f32(np.eye(3)), f32(np.zeros(3)),
    ), TIMING_RUNS)
    solve_ms = _wall_ms(lambda: minimizer.solve(port.Options(), matched, identity), 3)
    emit(
        "main_path_timing", metric="register_ndt_wall_ms", runs=len(walls),
        median_ms=median_ms, min_ms=min(walls), max_ms=max(walls),
        ms_per_lm_evaluation=median_ms / evaluations,
        match_ms=match_ms, first_inner_solve_ms=solve_ms,
        first_inner_solve_ms_per_iteration=solve_ms / inner[0] if inner[0] else None,
        device=name, nvidia_smi=smi,
    )
    prof = _profile(register)
    emit("main_path_profile", device_kernels_per_lm_evaluation=prof["device_kernels"] / evaluations,
         **prof)

    # ---- 4. the f64 oracle on the card ------------------------------------
    for oracle_name, oracle, pose, cls, cost_atol in (
        ("ORACLE_SIMPLE_6DOF", testing.ORACLE_SIMPLE_6DOF, true_pose,
         port.MahalanobisDistanceMinimizer, 0.1),
        ("ORACLE_3DOF6DOF_6DOF", testing.ORACLE_3DOF6DOF_6DOF, planar_pose,
         port.MahalanobisDistanceMinimizer, 0.1),
        # 4.0: the reference's scalar 3-DoF solver drops the n % 4 tail
        # correspondences, up to 1.0 of cost each; counts and pose exact
        ("ORACLE_3DOF6DOF_3DOF", testing.ORACLE_3DOF6DOF_3DOF, planar_pose,
         port.MahalanobisDistanceMinimizer3DOF, 4.0),
    ):
        m64 = cls(backend="torch", dtype=torch.float64, device="cuda").set_loss_function(loss)
        res64 = port.register_ndt(
            ndt_map, pose.inverse().apply(scan), identity, m64, port.Options()
        )
        testing.check_oracle(res64, oracle, cost_atol=cost_atol, pose_atol=1e-6)
        emit(
            "f64_oracle", oracle=oracle_name, outer=res64.outer_iterations,
            cost_atol=cost_atol,
            trace=[(float(s.final_cost), int(s.iterations)) for s in res64.summaries],
        )
    r64 = port.ReprojectionErrorMinimizer(
        backend="torch", dtype=torch.float64, device="cuda"
    ).set_loss_function(loss)
    data64 = reprojection.ReprojectionData(
        *(torch.as_tensor(a, dtype=torch.float64, device=dev)
          for a in (r_pts, r_pix, np.ones(r_pts.shape[0])))
    )
    pose64, sum64 = r64.solve(port.Options(), data64, intrinsics, identity)
    testing.check_reprojection_oracle(pose64, sum64, testing.ORACLE_REPROJ, rtol=1e-9)
    n64 = int(sum64.iterations)
    emit(
        "f64_oracle", oracle="ORACLE_REPROJ", rtol=1e-9, iterations=n64,
        trace=[(float(c), float(lam)) for c, lam in
               zip(sum64.records.cost[: n64 + 1].tolist(), sum64.records.lam[: n64 + 1].tolist())],
        reported_cost=float(sum64.reported_cost),
    )

    # ---- 5. slice 2's main path: the device-resident NdtRegistrar ----------
    def drive(reg, scan_local, init):
        """One register() with the launch counts set to 0 just before and
        read just after, and PyTorch's sync debug mode on inside every
        K-step block: a block that waits for the device fails the run."""
        block, synced = reg._block, []

        def guarded(*args):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    out = block(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            synced.extend(
                str(w.message)[:200] for w in caught if "synchroniz" in str(w.message)
            )
            return out

        reg._block = guarded
        ck.reset_launches()
        try:
            out = reg.register(scan_local, init)
            torch.cuda.synchronize()
        finally:
            del reg._block
        if synced:
            raise AssertionError(f"a block synchronised with the host: {synced[:3]}")
        return out, dict(ck.LAUNCHES), reg.run_stats()

    def check_path(label, kernel, reg, plain, scan_local, init):
        """Kernel path: launches of its one kernel == steps run; the plain
        path: no launch, the same outer and inner counts."""
        out, counts, stats = drive(reg, scan_local, init)
        want = {k: (stats["steps"] if k == kernel else 0) for k in counts}
        if counts != want or stats["steps"] == 0:
            raise AssertionError(f"{label}: launches {counts} != {want}")
        out_p, counts_p, _ = drive(plain, scan_local, init)
        if any(counts_p.values()):
            raise AssertionError(f"{label}: the plain path launched {counts_p}")
        if out.outer_iterations != out_p.outer_iterations or not np.array_equal(
            out.inner_iterations, out_p.inner_iterations
        ):
            raise AssertionError(
                f"{label}: kernel path {out.outer_iterations} {out.inner_iterations} "
                f"!= plain path {out_p.outer_iterations} {out_p.inner_iterations}"
            )
        if not np.isfinite(out.final_cost):
            raise AssertionError(f"{label}: final cost {out.final_cost}")
        return out, counts[kernel], stats, out_p

    def summary(out, stats, truth):
        return dict(
            outer=out.outer_iterations, inner=out.inner_iterations.tolist(),
            t_err_mm=float(np.linalg.norm(out.pose.translation - truth.translation)) * 1e3,
            final_cost=out.final_cost, steps=stats["steps"],
            wasted_steps=stats["wasted_steps"], host_reads=stats["host_reads"],
            block_steps=port.pipelines.fused_registration.BLOCK_STEPS,
            pose_t=out.pose.translation.tolist(), pose_q_wxyz=out.pose.quaternion().tolist(),
        )

    registrars = {
        "maha": (
            "maha6", local, identity, true_pose,
            lambda **kw: port.NdtRegistrar(ndt_map, port.Options(), loss, **kw),
        ),
        "planar": (
            "maha3", local_planar, identity, planar_pose,
            lambda **kw: port.NdtRegistrar(ndt_map, port.Options(), loss, planar=True, **kw),
        ),
        "p2p": (
            "p2p", local, p2p_start, true_pose,
            lambda **kw: port.NdtRegistrar(
                p2p_map, port.Options(), loss, objective="p2p", max_thickness=0.05, **kw
            ),
        ),
    }
    path_launches, runs = {}, {}
    for objective, (kernel, scan_local, init, truth, make) in registrars.items():
        reg = make()
        if reg.eval_backend != "cuda" or reg.device.type != "cuda":
            raise AssertionError((reg.eval_backend, reg.device))
        out, n_launch, stats, out_p = check_path(
            f"registrar_{objective}", kernel, reg, make(eval_backend="torch"), scan_local, init
        )
        path_launches[kernel] = n_launch
        runs[objective] = (reg, scan_local, init, stats)
        fields = summary(out, stats, truth)
        fields["plain_path_pose_diff"] = float(
            np.abs(out.pose.matrix() - out_p.pose.matrix()).max()
        )
        if objective == "maha":
            diff = float(np.abs(out.pose.matrix() - host_pose.matrix()).max())
            if not (fields["t_err_mm"] < 50.0 and diff < 1e-4):
                raise AssertionError(f"registrar_maha: t_err {fields['t_err_mm']} mm, "
                                     f"pose vs register_ndt {diff}")
            fields["pose_vs_register_ndt"] = diff
        elif objective == "planar":
            R, t = out.pose.rotation, out.pose.translation
            frozen = max(abs(t[2] - init.translation[2]), abs(R[2, 2] - 1.0),
                         float(np.abs(R[:2, 2]).max()), float(np.abs(R[2, :2]).max()))
            if frozen > 1e-7:
                raise AssertionError(f"registrar_planar: z/roll/pitch moved by {frozen}")
            fields["z_roll_pitch_change"] = frozen
        else:
            if not fields["t_err_mm"] < 50.0:
                raise AssertionError(f"registrar_p2p: t_err {fields['t_err_mm']} mm")
            # the minimizer on the first correspondences: kernel vs plain
            solved = {}
            for backend in ("cuda", "torch"):
                mini = port.PointToPlaneMinimizer(backend=backend).set_loss_function(loss)
                ck.reset_launches()
                pose_b, summ = mini.solve(port.Options(), p2p_matched, init)
                solved[backend] = (pose_b, int(summ.iterations), ck.LAUNCHES["p2p"])
            (pc, ic, lc), (pt, it, lt) = solved["cuda"], solved["torch"]
            mdiff = float(np.abs(pc.matrix() - pt.matrix()).max())
            if ic != it or mdiff > 1e-5 or lc == 0 or lt != 0:
                raise AssertionError(f"PointToPlaneMinimizer cuda vs torch: {solved}")
            fields["minimizer_cuda_vs_torch"] = {
                "iterations": ic, "pose_diff": mdiff, "cuda_launches": lc,
            }
        emit(f"registrar_{objective}", kernel=kernel, launches=n_launch, **fields)

    # lockstep batch: 16 copies of the maha-simple scan from bench.py's
    # sub-millimetre perturbed starts (bench.py:166-172)
    reg_m, local_m, init_m, _ = runs["maha"]
    B = 16
    starts = [port.Pose(np.eye(3), np.full(3, 1e-5 * (i + 1))) for i in range(B)]
    ck.reset_launches()
    batch = reg_m.register_batch([local] * B, starts)
    torch.cuda.synchronize()
    batch_launches, batch_stats = dict(ck.LAUNCHES), reg_m.run_stats()
    if batch_launches["maha6"] != batch_stats["steps"]:
        raise AssertionError(f"registrar_batch: launches {batch_launches} != {batch_stats}")
    worst_pose = 0.0
    for i, (start, lane) in enumerate(zip(starts, batch)):
        one = reg_m.register(local, start)
        diff = float(np.abs(lane.pose.matrix() - one.pose.matrix()).max())
        worst_pose = max(worst_pose, diff)
        if (lane.outer_iterations != one.outer_iterations
                or not np.array_equal(lane.inner_iterations, one.inner_iterations)
                or diff > 1e-5):
            raise AssertionError(
                f"registrar_batch lane {i}: {lane.outer_iterations} {lane.inner_iterations} "
                f"vs register {one.outer_iterations} {one.inner_iterations}, pose {diff}"
            )
    again = port.NdtRegistrar.finalize_batch(reg_m.register_batch_async([local] * B, starts))
    for lane, lane2 in zip(batch, again):
        if not (np.array_equal(lane.pose.matrix(), lane2.pose.matrix())
                and np.array_equal(lane.inner_iterations, lane2.inner_iterations)):
            raise AssertionError("register_batch_async + finalize_batch != register_batch")
    emit(
        "registrar_batch", batch=B, maha6_launches=batch_launches["maha6"],
        steps=batch_stats["steps"], wasted_steps=batch_stats["wasted_steps"],
        host_reads=batch_stats["host_reads"], worst_pose_vs_register=worst_pose,
        outer=[lane.outer_iterations for lane in batch],
        inner=[lane.inner_iterations.tolist() for lane in batch[:2]],
    )

    # ---- 6. slice 3's paths: the planar 3-DoF and PnP minimizers ----------
    def check_only(label, counts, kernel, want):
        """The path launched ``kernel`` exactly ``want`` > 0 times and no
        other kernel."""
        others = {k: v for k, v in counts.items() if k != kernel and v}
        if counts[kernel] != want or want == 0 or others:
            raise AssertionError(f"{label}: launches {counts}, want {kernel} = {want}")

    planar_runs = {}
    for backend in ("cuda", "torch"):
        mini = port.MahalanobisDistanceMinimizer3DOF(backend=backend, device="cuda")
        mini.set_loss_function(loss)
        if mini.dtype != torch.float32:
            raise AssertionError(mini.dtype)
        run = lambda mini=mini: port.register_ndt(
            ndt_map, local_planar, identity, mini, port.Options()
        )
        ck.reset_launches()
        planar_runs[backend] = (run, run(), dict(ck.LAUNCHES))
    run_planar, res_c, counts_c = planar_runs["cuda"]
    _, res_t, counts_t = planar_runs["torch"]
    planar_evals = _evaluations(res_c.summaries)
    check_only("planar_3dof", counts_c, "maha3c", planar_evals)
    if any(counts_t.values()):
        raise AssertionError(f"planar_3dof: the plain path launched {counts_t}")
    inner_c = [int(s.iterations) for s in res_c.summaries]
    inner_t = [int(s.iterations) for s in res_t.summaries]
    if res_c.outer_iterations != res_t.outer_iterations or inner_c != inner_t:
        raise AssertionError(
            f"planar_3dof: kernel path {res_c.outer_iterations} {inner_c} != "
            f"plain path {res_t.outer_iterations} {inner_t}"
        )
    R, t = res_c.pose.rotation, res_c.pose.translation
    frozen = max(abs(t[2]), abs(R[2, 2] - 1.0), float(np.abs(R[:2, 2]).max()),
                 float(np.abs(R[2, :2]).max()))
    # The reference's own planar solver ends 93 mm from the true pose on this
    # fixture (in y: ORACLE_3DOF6DOF_3DOF), so the port is held to the
    # reference's optimum; the distance to the true pose is reported.
    planar_t_err = float(np.linalg.norm(t - planar_pose.translation))
    planar_t_ref = float(np.linalg.norm(t - testing.ORACLE_3DOF6DOF_3DOF["translation"]))
    planar_cost = float(res_c.summaries[-1].final_cost)
    if not (planar_t_ref < 1e-4 and frozen == 0.0 and np.isfinite(planar_cost)):
        raise AssertionError(
            f"planar_3dof: {planar_t_ref} m from the reference's optimum, "
            f"z/roll/pitch change {frozen}, cost {planar_cost}"
        )
    path_launches["maha3c"] = counts_c["maha3c"]
    emit(
        "planar_3dof", outer=res_c.outer_iterations, inner=inner_c,
        lm_evaluations=planar_evals, maha3c_launches=counts_c["maha3c"],
        t_vs_reference_optimum_m=planar_t_ref, t_err_vs_true_pose_mm=planar_t_err * 1e3,
        z_roll_pitch_change=frozen, final_cost=planar_cost,
        plain_path_final_cost=float(res_t.summaries[-1].final_cost),
        plain_path_pose_diff=float(np.abs(res_c.pose.matrix() - res_t.pose.matrix()).max()),
        pose_t=t.tolist(), pose_q_wxyz=res_c.pose.quaternion().tolist(),
    )

    reproj_runs = {}
    for backend in ("cuda", "torch"):
        mini = port.ReprojectionErrorMinimizer(backend=backend, device="cuda")
        mini.set_loss_function(loss)
        if mini.dtype != torch.float32:
            raise AssertionError(mini.dtype)
        run = lambda mini=mini: mini.solve(port.Options(), reproj_data, intrinsics, identity)
        ck.reset_launches()
        reproj_runs[backend] = (run, *run(), dict(ck.LAUNCHES))
    run_reproj, pose_c, sum_c, counts_c = reproj_runs["cuda"]
    _, pose_t, sum_t, counts_t = reproj_runs["torch"]
    reproj_evals = _evaluations([sum_c])
    check_only("reprojection", counts_c, "reproj", reproj_evals)
    if any(counts_t.values()):
        raise AssertionError(f"reprojection: the plain path launched {counts_t}")
    reproj_t_err = float(np.linalg.norm(pose_c.translation - reproj_truth.inverse().translation))
    reproj_diff = float(np.abs(pose_c.matrix() - pose_t.matrix()).max())
    if not (reproj_t_err < 1e-4 and reproj_diff <= 1e-5):
        raise AssertionError(
            f"reprojection: t_err {reproj_t_err}, pose vs the plain path {reproj_diff}"
        )
    path_launches["reproj"] = counts_c["reproj"]
    emit(
        "reprojection", iterations=int(sum_c.iterations),
        plain_path_iterations=int(sum_t.iterations), lm_evaluations=reproj_evals,
        reproj_launches=counts_c["reproj"], t_err_m=reproj_t_err,
        plain_path_pose_diff=reproj_diff,
        costs=sum_c.records.cost[:reproj_evals].tolist(),
        plain_path_costs=sum_t.records.cost[: _evaluations([sum_t])].tolist(),
    )

    walls = _walls_ms(run_planar, TIMING_RUNS)
    reproj_walls = _walls_ms(run_reproj, TIMING_RUNS)
    emit(
        "slice3_timing", metric="wall_ms", runs=TIMING_RUNS,
        planar_register_ndt={
            "median_ms": statistics.median(walls), "min_ms": min(walls), "max_ms": max(walls),
            "lm_evaluations": planar_evals,
            "ms_per_lm_evaluation": statistics.median(walls) / planar_evals,
        },
        reprojection_solve={
            "median_ms": statistics.median(reproj_walls), "min_ms": min(reproj_walls),
            "max_ms": max(reproj_walls), "lm_evaluations": reproj_evals,
            "ms_per_lm_evaluation": statistics.median(reproj_walls) / reproj_evals,
        },
        device=name, nvidia_smi=smi,
    )
    prof = _profile(run_planar)
    emit("planar_profile", device_kernels_per_lm_evaluation=prof["device_kernels"] / planar_evals,
         **prof)
    prof = _profile(run_reproj)
    reproj_kernels = {k: c for k, c in prof["port_kernels"].items() if "Reproj" in k}
    if sum(prof["port_kernels"].values()) != reproj_evals or len(reproj_kernels) != 1:
        raise AssertionError(f"pnp_profile: port kernels {prof['port_kernels']} in the trace, "
                             f"ck.LAUNCHES {prof['port_launches']} in the profiled call, "
                             f"{reproj_evals} LM evaluations, want one reproj kernel each")
    emit("pnp_profile", device_kernels_per_lm_evaluation=prof["device_kernels"] / reproj_evals,
         port_kernels_per_lm_evaluation=sum(reproj_kernels.values()) / reproj_evals, **prof)

    # ---- 7. the registrar's timings (descriptive) ---------------------------
    timing = {}
    for objective, (reg, scan_local, init, stats) in runs.items():
        w = _walls_ms(lambda: reg.register(scan_local, init), TIMING_RUNS)
        timing[objective] = {
            "median_ms": statistics.median(w), "min_ms": min(w), "max_ms": max(w),
            "steps": stats["steps"], "host_reads": stats["host_reads"],
            "wasted_steps": stats["wasted_steps"],
            "ms_per_step": statistics.median(w) / stats["steps"],
        }
    batch_w = _walls_ms(lambda: reg_m.register_batch([local] * B, starts), 5)
    emit(
        "registrar_timing", metric="NdtRegistrar.register_wall_ms", runs=TIMING_RUNS,
        objectives=timing, batch16_ms_per_scan=statistics.median(batch_w) / B,
        batch16_median_ms=statistics.median(batch_w), device=name, nvidia_smi=smi,
    )
    for objective in ("maha", "p2p"):
        reg, scan_local, init, _ = runs[objective]
        prof = _profile(lambda: reg.register(scan_local, init))
        _check_traced_launches(f"registrar_profile {objective}", prof, reg.run_stats()["steps"])
        emit("registrar_profile", objective=objective,
             device_kernels_per_step=prof["device_kernels"] / reg.run_stats()["steps"], **prof)
    # what K, the steps per block, trades: wasted steps against host reads
    fused = port.pipelines.fused_registration
    default_k, sweep = fused.BLOCK_STEPS, {}
    try:
        for k in (1, 4, 8, 16):
            fused.BLOCK_STEPS = k
            w = _walls_ms(lambda: reg_m.register(local_m, init_m), 5)
            sweep[k] = {"median_ms": statistics.median(w), **reg_m.run_stats()}
    finally:
        fused.BLOCK_STEPS = default_k
    emit("registrar_block_sweep", objective="maha", runs=5, by_block_steps=sweep,
         device=name, nvidia_smi=smi)

    # the block's CUDA graph: each path's eager run, then a run that
    # captures its second block and one that replays every block, all with
    # the eager run's bits, run statistics and launch counts, and a
    # replayed run's traced kernels equal to its counted launches; two
    # async batches hand out tensors of their own; eager against graph in
    # turns; and K swept at B = 16 under graphs
    graph_cases = {
        "maha_b16": (reg_m, lambda: reg_m.register_batch_async([local] * B, starts)),
        "maha": (reg_m, lambda: reg_m.register_async(local_m, init_m)),
        **{o: (runs[o][0], lambda o=o: runs[o][0].register_async(*runs[o][1:3]))
           for o in ("planar", "p2p")},
    }
    d2d_graph = port.D2dRegistrar(p2p_map, port.Options())
    graph_cases["d2d"] = (d2d_graph, lambda: d2d_graph.register_async(local, identity))
    for solver in (port.LinearSolverType.DENSE_QR, port.LinearSolverType.CONJUGATE_GRADIENT):
        reg_s = port.NdtRegistrar(ndt_map, port.Options(linear_solver_type=solver), loss)
        tag = {"DENSE_QR": "qr", "CONJUGATE_GRADIENT": "cg"}[solver.name]
        graph_cases[f"maha_b16_{tag}"] = (
            reg_s, lambda r=reg_s: r.register_batch_async([local] * B, starts))
        graph_cases[f"maha_{tag}"] = (reg_s, lambda r=reg_s: r.register_async(local_m, init_m))
    can_capture = fused._can_capture
    eager_only = lambda device: False

    def graph_run(reg, run, capture):
        fused._can_capture = capture
        try:
            ck.reset_launches()
            out = run()
            torch.cuda.synchronize()
        finally:
            fused._can_capture = can_capture
        return out, reg.run_stats(), dict(ck.LAUNCHES)

    graph_report = {}
    for label, (reg, run) in graph_cases.items():
        reg._graph = None
        eager, eager_stats, eager_launches = graph_run(reg, run, eager_only)
        reads = eager_stats["host_reads"]
        capture_ms = None
        for graph_blocks in (reads - 1, reads):
            t0 = time.perf_counter()
            out, stats, launches = graph_run(reg, run, can_capture)
            capture_ms = capture_ms or 1e3 * (time.perf_counter() - t0)
            for a, b in zip(out, eager):
                torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                           msg=f"registrar_graph {label}: a result's bits differ")
            if launches != eager_launches or stats != {**eager_stats, "graph_blocks": graph_blocks}:
                raise AssertionError(f"registrar_graph {label}: graph run {stats} {launches}; "
                                     f"eager {eager_stats} {eager_launches}")
        prof = _profile(run, warm=False)  # every block replayed
        if reg.run_stats()["graph_blocks"] != reads:
            raise AssertionError(f"registrar_graph {label}: profiled run {reg.run_stats()}")
        _check_traced_launches(f"registrar_graph {label}", prof, eager_stats["steps"])
        walls = {"eager": [], "graph": []}
        for i in range(10):  # in turns
            mode, capture = (("eager", eager_only), ("graph", can_capture))[i % 2]
            t0 = time.perf_counter()
            graph_run(reg, run, capture)
            walls[mode].append(1e3 * (time.perf_counter() - t0))
        graph_report[label] = {
            "steps": eager_stats["steps"], "host_reads": reads,
            "launches": {k: v for k, v in eager_launches.items() if v},
            "traced_port_kernels": prof["port_kernels"], "capturing_run_ms": capture_ms,
            **{f"{k}_median_ms": statistics.median(v) for k, v in walls.items()},
        }
    first = reg_m.register_batch_async([local] * B, starts)
    kept = [a.clone() for a in first]
    second = reg_m.register_batch_async([local] * B, starts)
    torch.cuda.synchronize()
    for a, b in zip(first, kept):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                   msg="registrar_graph: a second batch changed the first's results")
    if {a.data_ptr() for a in first} & {a.data_ptr() for a in second}:
        raise AssertionError("registrar_graph: two async batches share their result tensors")
    sweep16 = {}
    try:
        for k in (1, 4, 8, 16):
            fused.BLOCK_STEPS = k
            w = _walls_ms(lambda: reg_m.register_batch([local] * B, starts), 5)
            sweep16[k] = {"median_ms": statistics.median(w), **reg_m.run_stats()}
    finally:
        fused.BLOCK_STEPS = default_k
    emit("registrar_graph", cases=graph_report, bitwise_equal=True, async_results_own=True,
         batch16_by_block_steps=sweep16, graph_lanes=reg_m._graph.key[0][0],
         device=name, nvidia_smi=smi)

    # ---- 7b. slice 7: batched solves, the vmap registrar, D2D, loop closure -
    def lm_rounds(iterations, max_it) -> int:
        """LM evaluations of a solve from its reported iteration count: one
        more than it on a tolerance stop, max_it at the cap."""
        return min(int(iterations) + 1, max_it)

    def pose_diff(a, b) -> float:
        return float(np.abs(a.matrix() - b.matrix()).max())

    # each kernel against its plain version at the batched shapes of the
    # paths below, lane by lane: random rows (about 10 % masked) and a
    # distinct random pose in every lane, so that a lane reading another
    # lane's rows or params, or a cluster finishing into the wrong problem,
    # shows; and each lane bitwise equal to the same problem launched alone
    def lane_poses(count):
        out = []
        for _ in range(count):
            axis = rng.normal(size=3)
            out.append(port.Pose.from_axis_angle(0.1 * rng.normal(), axis, 0.1 * rng.normal(size=3)))
        return out

    def batch_vs_plain(kernel, packed, label):
        B = packed.shape[0]
        worst = 0.0
        poses_b = lane_poses(B)
        for loss_ in losses:
            code, params_b = params_of(kernel, poses_b, loss_)
            got = partials[kernel](params_b, packed, code)
            worst = max(worst, check_close(
                f"{kernel} {label} {type(loss_).__name__}", got,
                terms[kernel](params_b, packed, code),
            ))
        alone = torch.cat([partials[kernel](params_b[b : b + 1], packed[b : b + 1], code)
                           for b in range(B)])
        if not same_bits(got, alone):
            raise AssertionError(f"{kernel} {label}: a lane differs from its problem alone")
        return worst

    batched_shapes = {
        "maha6": [(16, 19456), (4, 18712)], "maha3": [(4, 18712)],
        "reproj": [(256, 1024)], "p2p": [(16, 10240), (4, 9356)],
    }
    shape_report = {}
    for kernel, shapes in batched_shapes.items():
        for B_, n in shapes:
            packed = ck.lane_aligned(torch.stack([random_packed(kernel, n) for _ in range(B_)]))
            shape_report[f"{kernel}_b{B_}_n{n}"] = batch_vs_plain(kernel, packed, f"B={B_} N={n}")
    emit("batch_vs_plain", rtol_of_abs_sum=RTOL, atol=ATOL, losses=len(losses),
         random_rows_max_abs_err=shape_report, lanes_bitwise_as_alone=True)

    opts = port.Options()
    max_it = opts.max_iterations
    # The batch invariance of an LM iteration's ops. cuSOLVER factors a lone
    # matrix (potrf) with another rounding than a batch (potrfBatched);
    # solvers/linear._cholesky_ex therefore factors a lone matrix as a batch
    # of two. That rests on torch's dispatch (one matrix or a batch of one
    # to potrf, two or more to potrfBatched), which the probe holds on
    # every run; the kernels' lanes are held above (batch_vs_plain).
    linear = port.solvers.linear
    crng = np.random.default_rng(SEED + 11)
    spd = crng.normal(size=(256, 6, 6))
    spd = torch.as_tensor(spd @ spd.transpose(0, 2, 1) + 6.0 * np.eye(6), dtype=torch.float32,
                          device=dev)
    rhs = torch.as_tensor(crng.normal(size=(256, 6)), dtype=torch.float32, device=dev)
    raw = torch.linalg.cholesky_ex(spd)[0]
    raw_lone = torch.stack([torch.linalg.cholesky_ex(h)[0] for h in spd])
    raw_one = torch.cat([torch.linalg.cholesky_ex(h[None])[0] for h in spd])
    raw_pair = torch.cat([torch.linalg.cholesky_ex(spd[b : b + 2])[0] for b in range(0, 256, 2)])

    def unfixed_solve(factor):
        y = torch.linalg.solve_triangular(factor, rhs[..., None], upper=False)
        return torch.linalg.solve_triangular(factor.mT, y, upper=True)[..., 0]

    tri_lone = torch.cat([
        torch.linalg.solve_triangular(f[None], r[None, :, None], upper=False)[..., 0]
        for f, r in zip(raw, rhs)
    ])
    tri = torch.linalg.solve_triangular(raw, rhs[..., None], upper=False)[..., 0]
    norms = torch.sqrt(torch.sum(rhs * rhs, dim=-1))
    norms_lone = torch.stack([torch.sqrt(torch.sum(r * r, dim=-1)) for r in rhs])
    dense = port.LinearSolverType.DENSE_CHOLESKY
    solved = linear.solve_normal_equations(spd, rhs, dense)
    solved_lone = torch.stack([
        linear.solve_normal_equations(h, r, dense) for h, r in zip(spd, rhs)
    ])
    dispatch = (f"solvers/linear._cholesky_ex assumes that torch {torch.__version__} factors "
                f"one matrix with cuSOLVER potrf and a batch of two or more with potrfBatched")
    if not same_bits(raw, raw_pair):
        raise AssertionError(f"cholesky_probe: a batch of two and of 256 differ; {dispatch}")
    if not (same_bits(solved, solved_lone) and same_bits(tri, tri_lone)
            and same_bits(norms, norms_lone)):
        raise AssertionError(
            f"cholesky_probe: solve_normal_equations, solve_triangular or a norm differs "
            f"between a lone problem and a batch; {dispatch}"
        )
    cholesky_probe = {
        "matrices": 256, "torch": torch.__version__,
        "cholesky_ex_lone_vs_batched_bitwise": same_bits(raw, raw_lone),
        "cholesky_ex_lone_vs_batched_max_diff": float((raw - raw_lone).abs().max()),
        "cholesky_ex_batch_of_one_vs_lone_bitwise": same_bits(raw_one, raw_lone),
        "cholesky_ex_batch_of_two_vs_256_bitwise": True,
        "solve_with_lone_factors_vs_batched_max_diff": float(
            (unfixed_solve(raw_lone.contiguous()) - unfixed_solve(raw.contiguous())).abs().max()
        ),
        "solve_triangular_lone_vs_batched_bitwise": True,
        "norm_lone_vs_batched_bitwise": True,
        "solve_normal_equations_lone_vs_batched_bitwise": True,
    }
    # maha: the 16 perturbed starts of bench.py:166-172, each matched once
    # at its start (k = 2), padded as the minimizer pads (19,456 lanes)
    maha_starts = [port.Pose(np.eye(3), np.full(3, 1e-5 * (i + 1))) for i in range(16)]
    maha_items = [
        matching.match_point_cloud(
            f32(valid.means), f32(valid.sqrt_informations), f32(local), ones,
            f32(s.rotation), f32(s.translation),
        ).pad_to(19456)
        for s in maha_starts
    ]
    # PnP: the 630-point frame, 256 starts from the seed, padded to 1,024
    prng = np.random.default_rng(SEED + 7)
    pnp_starts = [port.Pose(np.eye(3), 0.05 * prng.normal(size=3)) for _ in range(256)]
    pnp_item = reproj_data.pad_to(1024)
    # p2p: 16 starts around P2P_START_T, each matched once (k = 4), padded
    # to 10,240 lanes
    p2p_starts = [port.Pose(np.eye(3), np.asarray(P2P_START_T) + 1e-5 * (i + 1))
                  for i in range(16)]
    p2p_items = [
        matching.match_point_to_plane(
            m.means_T.T, m.normals_T.T, m.voxel_weights, f32(local), ones,
            f32(s.rotation), f32(s.translation), num_neighbors=4,
        ).pad_to(10240)
        for s in p2p_starts
    ]
    stack = lambda items: type(items[0])(*(torch.stack(f) for f in zip(*items)))
    # Limits: a batched instance and its serial solve run the same kernel
    # (whose sums do not depend on B) and the same batch-invariant linear
    # solve, so they agree to SERIAL_POSE_ATOL; the plain path sums in
    # another order, so it agrees to the limits of the single-problem
    # phases above (1e-5 for PnP, 1e-4 for the registrations).
    SERIAL_POSE_ATOL = 1e-6
    batch_cases = {
        "maha": ("maha6", ck.pack_maha6, maha_starts, maha_items, 1e-4,
                 lambda d, st, backend=None: port.solve_mahalanobis_batch(
                     opts, d, st, loss, backend=backend),
                 lambda d, s0: port.MahalanobisDistanceMinimizer().set_loss_function(loss)
                 .solve(opts, d, s0)),
        "pnp": ("reproj", ck.pack_reproj, pnp_starts, [pnp_item] * len(pnp_starts), 1e-5,
                lambda d, st, backend=None: port.solve_reprojection_batch(
                    opts, d, intrinsics, st, loss, backend=backend),
                lambda d, s0: port.ReprojectionErrorMinimizer().set_loss_function(loss)
                .solve(opts, d, intrinsics, s0)),
        "p2p": ("p2p", ck.pack_p2p, p2p_starts, p2p_items, 1e-4,
                lambda d, st, backend=None: port.solve_point_to_plane_batch(
                    opts, d, st, loss, backend=backend),
                lambda d, s0: port.PointToPlaneMinimizer().set_loss_function(loss)
                .solve(opts, d, s0)),
    }
    batch_report = {}
    for label, (kernel, pack, starts_b, items, plain_atol, batched_fn, serial_fn) in (
            batch_cases.items()):
        data_b = stack(items)
        ck.reset_launches()
        poses_b, iters_b, costs_b = batched_fn(data_b, starts_b)
        torch.cuda.synchronize()
        counts = dict(ck.LAUNCHES)
        rounds = max(lm_rounds(i, max_it) for i in iters_b)
        check_only(f"batched_{label}", counts, kernel, rounds)
        # the path's own rows against the plain version, lane by lane
        rows_err = batch_vs_plain(kernel, pack(data_b), f"batched_{label} rows")
        torch.cuda.synchronize()
        t_serial = time.perf_counter()
        serial = [serial_fn(d, s0) for d, s0 in zip(items, starts_b)]
        torch.cuda.synchronize()
        serial_ms = (time.perf_counter() - t_serial) * 1e3  # one pass: the checked one
        serial_iters = [int(su.iterations) for _, su in serial]
        worst_pose = max(pose_diff(p, sp) for p, (sp, _) in zip(poses_b, serial))
        if (iters_b.tolist() != serial_iters or worst_pose > SERIAL_POSE_ATOL
                or not np.all(np.isfinite(costs_b))):
            raise AssertionError(
                f"batched_{label}: iterations {iters_b.tolist()} vs serial {serial_iters}, "
                f"pose difference {worst_pose} (limit {SERIAL_POSE_ATOL})"
            )
        # the same batch through the plain path: no launch, every pose within
        # plain_atol, the same counts except where both paths ended at a
        # cost of exactly 0: there the solve has converged and its stop
        # turns on the last bits of a step norm, which the two orders of
        # summation round differently
        ck.reset_launches()
        poses_p, iters_p, costs_p = batched_fn(data_b, starts_b, backend="torch")
        if any(ck.LAUNCHES.values()):
            raise AssertionError(f"batched_{label}: the plain path launched {dict(ck.LAUNCHES)}")
        plain_pose = max(pose_diff(p, pp) for p, pp in zip(poses_b, poses_p))
        apart = [b for b, (i, j) in enumerate(zip(iters_b, iters_p)) if i != j]
        gaps = {b: (int(iters_b[b]), int(iters_p[b]), float(costs_b[b]), float(costs_p[b]))
                for b in apart}
        unsettled = {b: g for b, g in gaps.items() if g[2] != 0.0 or g[3] != 0.0}
        if unsettled or plain_pose > plain_atol:
            raise AssertionError(
                f"batched_{label}: kernel vs plain path, (iterations, plain iterations, "
                f"final cost, plain final cost) of the instances apart at a non-zero cost "
                f"{unsettled}, pose difference {plain_pose} (limit {plain_atol})"
            )
        batched_ms = _wall_ms(lambda: batched_fn(data_b, starts_b), 5)
        B = len(starts_b)
        batch_report[label] = {
            "batch": B, "n": int(items[0].mask.shape[0]), "kernel": kernel,
            "launches": counts[kernel], "batched_lm_iterations": rounds,
            "iterations": sorted(set(iters_b.tolist())),
            "counts_equal_serial": True, "max_pose_diff_vs_serial": worst_pose,
            "serial_pose_atol": SERIAL_POSE_ATOL,
            "counts_apart_from_plain_path_at_zero_cost": len(apart),
            "count_gaps_vs_plain_path": sorted(
                {abs(g[0] - g[1]) for g in gaps.values()}),
            "counts_apart_instances": apart, "max_pose_diff_vs_plain_path": plain_pose,
            "plain_path_pose_atol": plain_atol, "rows_vs_plain_max_abs_err": rows_err,
            "batched_ms_per_solve": batched_ms / B, "serial_ms_per_solve": serial_ms / B,
            "batched_median_ms": batched_ms, "serial_ms": serial_ms, "batched_runs": 5,
            "serial_runs": 1,
        }
    # the async form and its one copy to the host give the same bits
    data_b = stack(maha_items)
    blocking = port.solve_mahalanobis_batch(opts, data_b, maha_starts, loss)
    deferred = port.finalize_solve_batch(
        port.solve_mahalanobis_batch_async(opts, data_b, maha_starts, loss)
    )
    if not (np.array_equal(blocking[1], deferred[1]) and np.array_equal(blocking[2], deferred[2])
            and all(np.array_equal(a.matrix(), b.matrix())
                    for a, b in zip(blocking[0], deferred[0]))):
        raise AssertionError("solve_mahalanobis_batch_async + finalize != blocking")
    emit("batched_solves", cases=batch_report, async_bitwise_equal=True,
         cholesky_probe=cholesky_probe,
         device=name, nvidia_smi=smi)

    # the vmap registrar at B = 4, full N, against register and lockstep
    vmap_report = {}
    for objective, (kernel, scan_local, init, truth, make) in registrars.items():
        reg = runs[objective][0]
        plain_reg = make(eval_backend="torch")
        starts4 = [
            port.Pose(init.rotation, init.translation + 1e-5 * (i + 1)) for i in range(4)
        ]
        modes = {}
        for mode in ("lockstep", "vmap"):
            ck.reset_launches()
            lanes = reg.register_batch([scan_local] * 4, starts4, mode=mode)
            torch.cuda.synchronize()
            counts, stats = dict(ck.LAUNCHES), reg.run_stats()
            check_only(f"registrar_{mode}_{objective}", counts, kernel, stats["steps"])
            wall = _wall_ms(lambda: reg.register_batch([scan_local] * 4, starts4, mode=mode), 3)
            # the same batch through the plain evaluation: no launch
            ck.reset_launches()
            plain_lanes = plain_reg.register_batch([scan_local] * 4, starts4, mode=mode)
            if any(ck.LAUNCHES.values()):
                raise AssertionError(f"registrar_{mode}_{objective}: the plain path launched "
                                     f"{dict(ck.LAUNCHES)}")
            modes[mode] = (lanes, counts[kernel], stats, wall, plain_lanes)
        # every lane equals register of its scan (the same kernel at B = 1)
        # and the plain path's lane (pose within 1e-4, the registrar's limit)
        worst_pose, worst_plain = 0.0, 0.0
        for i, start in enumerate(starts4):
            one = reg.register(scan_local, start)
            for mode, (lanes, _, _, _, plain_lanes) in modes.items():
                for ref_name, ref in (("register", one), ("plain path", plain_lanes[i])):
                    lane = lanes[i]
                    diff = pose_diff(lane.pose, ref.pose)
                    if mode == "vmap" and ref is one:
                        worst_pose = max(worst_pose, diff)
                    elif mode == "vmap":
                        worst_plain = max(worst_plain, diff)
                    if (lane.outer_iterations != ref.outer_iterations
                            or not np.array_equal(lane.inner_iterations, ref.inner_iterations)
                            or diff > 1e-4):
                        raise AssertionError(
                            f"registrar_vmap {objective} {mode} lane {i}: "
                            f"{lane.outer_iterations} {lane.inner_iterations} vs {ref_name} "
                            f"{ref.outer_iterations} {ref.inner_iterations}, pose {diff}"
                        )
        vmap_report[objective] = {
            "kernel": kernel, "batch": 4, "outer": [l.outer_iterations for l in modes["vmap"][0]],
            "max_pose_diff_vs_register": worst_pose,
            "counts_equal_plain_path": True, "max_pose_diff_vs_plain_path": worst_plain,
            **{f"{mode}_{k}": v for mode, (_, n_launch, stats, wall, _) in modes.items()
               for k, v in (("launches", n_launch), ("steps", stats["steps"]),
                            ("host_reads", stats["host_reads"]), ("wall_ms", wall))},
        }
    emit("registrar_vmap", objectives=vmap_report, device=name, nvidia_smi=smi)

    # D2D: the host loop and the D2dRegistrar on the unquirked map, with the
    # scan voxel size of examples/ndt_registration.py:82 (the default, 0.5)
    d2d_mini = port.MahalanobisDistanceMinimizer()
    run_d2d_host = lambda: port.register_d2d_ndt(p2p_map, local, identity, d2d_mini, opts)
    ck.reset_launches()
    res_d2d = run_d2d_host()
    torch.cuda.synchronize()
    counts = dict(ck.LAUNCHES)
    d2d_evals = _evaluations(res_d2d.summaries)
    check_only("d2d_host", counts, "maha6", d2d_evals)
    d2d_reg = port.D2dRegistrar(p2p_map, opts)
    d2d_plain = port.D2dRegistrar(p2p_map, opts, eval_backend="torch")
    ck.reset_launches()
    res_fused = d2d_reg.register(local, identity)
    torch.cuda.synchronize()
    fused_counts, fused_stats = dict(ck.LAUNCHES), d2d_reg.run_stats()
    check_only("d2d_registrar", fused_counts, "maha6", fused_stats["steps"])
    res_plain = d2d_plain.register(local, identity)
    d2d_t = {k: float(np.linalg.norm(r.pose.translation - true_pose.translation))
             for k, r in (("host", res_d2d), ("registrar", res_fused))}
    if (max(d2d_t.values()) >= 0.01
            or res_fused.outer_iterations != res_plain.outer_iterations
            or not np.array_equal(res_fused.inner_iterations, res_plain.inner_iterations)):
        raise AssertionError(
            f"d2d: t_err {d2d_t}, registrar {res_fused.outer_iterations} "
            f"{res_fused.inner_iterations} vs plain {res_plain.outer_iterations} "
            f"{res_plain.inner_iterations}"
        )
    emit(
        "d2d", scan_voxel_resolution=0.5, map="identity_moment=False",
        host={"outer": res_d2d.outer_iterations,
              "inner": [int(s.iterations) for s in res_d2d.summaries],
              "lm_evaluations": d2d_evals, "maha6_launches": counts["maha6"],
              "t_err_mm": d2d_t["host"] * 1e3, "median_ms": _wall_ms(run_d2d_host, 5)},
        registrar={"outer": res_fused.outer_iterations,
                   "inner": res_fused.inner_iterations.tolist(),
                   "maha6_launches": fused_counts["maha6"], **fused_stats,
                   "t_err_mm": d2d_t["registrar"] * 1e3,
                   "plain_path_pose_diff": pose_diff(res_fused.pose, res_plain.pose),
                   "median_ms": _wall_ms(lambda: d2d_reg.register(local, identity), 5)},
        device=name, nvidia_smi=smi,
    )

    # loop closure: tests/test_loop_closure.py's revisit, on the full room
    # fixture filtered at 0.15 m
    lc_scan = ndt.filter_points(pts, 0.15)

    def yaw_pose(x, y, yaw, z=0.3):
        c, s_ = np.cos(yaw), np.sin(yaw)
        return port.Pose(np.array([[c, -s_, 0.0], [s_, c, 0.0], [0.0, 0.0, 1.0]]),
                         np.array([x, y, z]))

    detector = port.LoopClosureDetector(min_id_gap=5, candidate_radius=1.0,
                                        identity_moment=False)
    kf0, kf1 = yaw_pose(0.0, 0.0, 0.0), yaw_pose(1.5, 0.8, 0.7)
    detector.add_keyframe(0, kf0.inverse().apply(lc_scan), kf0)
    detector.add_keyframe(1, kf1.inverse().apply(lc_scan), kf1)
    true_q, drift = yaw_pose(0.25, -0.1, 0.12), yaw_pose(0.08, 0.05, 0.03, z=0.0)
    est_q = port.Pose(drift.rotation @ true_q.rotation,
                      drift.rotation @ true_q.translation + drift.translation)
    query = true_q.inverse().apply(lc_scan)
    ck.reset_launches()
    closure = detector.detect(20, query, est_q)
    torch.cuda.synchronize()
    counts = dict(ck.LAUNCHES)
    expected = kf0.inverse() * true_q
    if closure is None or closure.reference_id != 0:
        raise AssertionError(f"loop_closure: {closure}")
    rel_err = float(np.linalg.norm(closure.relative_pose.translation - expected.translation))
    eig = np.linalg.eigvalsh(closure.sqrt_info.T @ closure.sqrt_info)
    if not (rel_err < 0.02 and closure.matched_fraction > 0.8 and eig[0] > 1.0
            and counts["maha6"] > 0):
        raise AssertionError(
            f"loop_closure: relative-pose error {rel_err}, fraction "
            f"{closure.matched_fraction}, information eigenvalues {eig}, launches {counts}"
        )
    emit(
        "loop_closure", scan_points=int(lc_scan.shape[0]), reference_id=closure.reference_id,
        query_id=closure.query_id, relative_pose_err_mm=rel_err * 1e3,
        correction_mm=closure.correction * 1e3, matched_fraction=closure.matched_fraction,
        final_cost=closure.final_cost, information_eigenvalues=eig.tolist(),
        maha6_launches=counts["maha6"],
        detect_median_ms=_wall_ms(lambda: detector.detect(20, query, est_q), 3),
        device=name, nvidia_smi=smi,
    )

    # ---- 8. kernel timings and the kernels line ----------------------------
    def time_kernel(kernel, packed, poses) -> dict:
        rows, n_out, flop_per_factor = KERNEL_SHAPE[kernel]
        code, params = params_of(kernel, poses, loss)
        n = packed.shape[-1]
        kernel_ms, kernel_host_ms = _time_ms(lambda: partials[kernel](params, packed, code), 200)
        plain = lambda: terms[kernel](params, packed, code).sum(dim=-1)
        plain_ms, plain_host_ms = _time_ms(plain, 50)
        # each row read once (2 bytes an element for bf16 rows), each output
        # written once
        nbytes = rows * n * packed.element_size() + params.numel() * 4 + n_out * 4
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        flop_ms = n * flop_per_factor / PEAK_FP32_FLOP_PER_S * 1e3
        row = dict(
            kernel=kernel, rows_dtype=str(packed.dtype)[6:], n=n, device=name, nvidia_smi=smi,
            ms_back_to_back=kernel_ms, ms_host_bound=kernel_host_ms,
            plain_ms_back_to_back=plain_ms, plain_ms_host_bound=plain_host_ms,
            bytes=nbytes, flop=n * flop_per_factor, bytes_ms=bytes_ms, flop_ms=flop_ms,
        )
        emit("kernel_timing", **row)
        return row

    # an empty kernel through the same ctypes path: the launch floor
    floor_ms, floor_host_ms = _time_ms(lambda: ck._empty_launch(dev), 200)
    # the cluster finish against the ticket's, in turns: reproj at PnP's N,
    # 8 and 16 tiles through the cluster, against the same problem
    # zero-padded to ticket_n lanes (17 tiles, one block each, so the same
    # latency chain, plus the blocks of the zero tiles) through the ticket
    finish_ab = {}
    for packed, poses in [
        cases["reproj"]["fixture_n630"],
        *[(ck.lane_aligned(random_packed("reproj", n)[None]), [rand_pose]) for n in (4096, 8192)],
    ]:
        code, params = params_of("reproj", poses, loss)
        padded = padded_to_ticket(packed)
        calls = {"cluster": lambda: partials["reproj"](params, packed, code),
                 "ticket": lambda: partials["reproj"](params, padded, code)}
        times = {"ticket": [], "cluster": []}
        for finish in ("ticket", "cluster", "cluster", "ticket"):
            times[finish].append(_time_ms(calls[finish], 200))
        if not same_bits(calls["cluster"](), calls["ticket"]()):
            raise AssertionError(f"reproj n{packed.shape[-1]}: the two finishes differ")
        finish_ab[f"reproj/n{packed.shape[-1]}"] = {
            "cluster_blocks": ck.onepass_cluster_blocks(packed.shape[-1]),
            **{f"{k}_ms_back_to_back": [t[0] for t in v] for k, v in times.items()},
            **{f"{k}_ms_host_bound": [t[1] for t in v] for k, v in times.items()},
        }
    emit("finish_ab", order="ticket cluster cluster ticket", ticket_padded_to_n=ticket_n,
         bitwise_equal=True, designs=finish_ab, device=name, nvidia_smi=smi)
    ab, ladder = {}, {}
    for kernel in ck.ONE_PASS:
        n_out = KERNEL_SHAPE[kernel][1]
        # where a small call's time goes: no factor (the launch and the
        # cluster finish of one block), then one tile of 512 lanes
        for n in (0, ck.ONE_PASS_TILE):
            code, params = params_of(kernel, [rand_pose], loss)
            packed = ck.lane_aligned(random_packed(kernel, n)[None])
            ladder[f"{kernel}/n{n}"] = _time_ms(
                lambda: partials[kernel](params, packed, code), 200
            )[0]
        # the main path's N and a large N, twice each: the spread of a time
        for packed, poses in (
            cases[kernel][main_case[kernel]],
            (ck.lane_aligned(random_packed(kernel, 1_000_003)[None]), [rand_pose]),
        ):
            code, params = params_of(kernel, poses, loss)
            times = [_time_ms(lambda: partials[kernel](params, packed, code), 200)
                     for _ in range(2)]
            contiguous = packed.contiguous()
            nbytes = contiguous.numel() * 4 + params.numel() * 4 + n_out * 4
            # a yardstick of the rate the card streams these bytes at: a
            # device copy of the buffer, which reads and writes each byte
            dst = torch.empty_like(contiguous)
            copy_ms = _time_ms(lambda: dst.copy_(contiguous), 200)[0]
            ab[f"{kernel}/n{packed.shape[-1]}"] = {
                "bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
                "copy_ms": copy_ms,
                "copy_bytes_per_s": 2 * contiguous.numel() * 4 / (copy_ms * 1e-3),
                "one_pass_ms_back_to_back": [t[0] for t in times],
                "one_pass_ms_host_bound": [t[1] for t in times],
            }
    emit("onepass_ab", empty_kernel_ms_back_to_back=floor_ms,
         empty_kernel_ms_host_bound=floor_host_ms, one_pass_small_n_ms_back_to_back=ladder,
         designs=ab, device=name, nvidia_smi=smi)

    # ---- 2c. the bf16-row instantiations of maha6 and maha3 ----------------
    # The same kernels over pack_maha6(..., buffer_dtype=torch.bfloat16)
    # rows: each held to its plain version (the rows widened to float32) on
    # the phase-2 cases, the edge N and zero padding, and to the float32
    # kernel on the widened rows bit for bit (only the loads differ); then
    # their main path, run_all.py's rate solve (_packed_lm_solve, 40 LM
    # iterations forced) on the fixture's bf16 rows, launches counted.
    from nonlinear_optimizer_for_slam_tpu_torch.core.options import ConvergenceHandle
    from nonlinear_optimizer_for_slam_tpu_torch.pipelines import fused_registration as fr

    def to_bf16(packed):
        return ck.lane_aligned(packed.to(torch.bfloat16))

    bf16_cases = {
        kernel: {
            "fixture_n18712": (to_bf16(fixture_packed)[None], [identity]),
            "ragged_n1000003": (to_bf16(random_packed(kernel, 1_000_003))[None], [rand_pose]),
            "batch3": (to_bf16(batch3(kernel)), [rand_pose, identity, rand_pose.inverse()]),
        }
        for kernel in ck.BF16_ROWS
    }
    bf16_report = {}
    for kernel, kcases in bf16_cases.items():
        report = {}
        for case, (packed, poses) in kcases.items():
            widened = ck.lane_aligned(packed.float())
            for loss_ in losses:
                code, params = params_of(kernel, poses, loss_)
                got = partials[kernel](params, packed, code)
                again = partials[kernel](params, packed, code)
                label = f"{kernel} bf16 {case} {type(loss_).__name__}"
                if not same_bits(got, again):
                    raise AssertionError(f"{label}: two runs differ")
                if not same_bits(got, partials[kernel](params, widened, code)):
                    raise AssertionError(f"{label}: not the float32 kernel's bits on the "
                                         "widened rows")
                err = check_close(label, got, terms[kernel](params, packed, code))
                worst[(f"{kernel}_bf16", case, type(loss_).__name__)] = err
                report[f"{case}/{type(loss_).__name__}"] = err
        packed, poses = kcases["fixture_n18712"]
        code, params = params_of(kernel, poses, losses[1])
        padded = to_bf16(torch.nn.functional.pad(packed, (0, 4099)))
        if not same_bits(partials[kernel](params, packed, code),
                         partials[kernel](params, padded, code)):
            raise AssertionError(f"{kernel} bf16: zero padding changes the result")
        for n in (0, 1, 3, 1023, 1025, 18713):
            packed = to_bf16(random_packed(kernel, n))[None]
            for loss_ in losses:
                code, params = params_of(kernel, [rand_pose], loss_)
                label = f"{kernel} bf16 n{n} {type(loss_).__name__}"
                got = partials[kernel](params, packed, code)
                if n == 0 and bool(got.any()):
                    raise AssertionError(f"{label}: {got.tolist()} for no factor")
                report[f"n{n}/{type(loss_).__name__}"] = check_close(
                    label, got, terms[kernel](params, packed, code))
        bf16_report[kernel] = report
    # the main path: 40 forced LM iterations on the fixture's bf16 rows
    rate_opts = port.Options().replace(convergence_handle=ConvergenceHandle(0.0, 0.0, 0.0))
    rate_loss = port.ExponentialLoss(1.0, 1.0)
    rows16 = to_bf16(fixture_packed)
    rows32 = ck.lane_aligned(rows16.float())
    t_start = torch.zeros(3, device=dev)
    q_start = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    bf16_path = {}
    for kernel, planar in (("maha6", False), ("maha3", True)):
        ck.reset_launches()
        out16 = fr._packed_lm_solve(t_start, q_start, rows16, rate_loss, rate_opts, planar=planar)
        torch.cuda.synchronize()
        launches16 = dict(ck.LAUNCHES)
        ck.reset_launches()
        out32 = fr._packed_lm_solve(t_start, q_start, rows32, rate_loss, rate_opts, planar=planar)
        torch.cuda.synchronize()
        launches32 = dict(ck.LAUNCHES)
        iters = int(out16[2].item())
        others = {k: v for k, v in launches16.items() if k != f"{kernel}_bf16" and v}
        if not (launches16[f"{kernel}_bf16"] == iters == 40 and not others
                and launches32[kernel] == 40):
            raise AssertionError(f"bf16 {kernel} path: launches {launches16} / {launches32} "
                                 f"for {iters} LM iterations")
        if not all(torch.equal(a, b) for a, b in zip(out16, out32)):
            raise AssertionError(f"bf16 {kernel} path: not the float32 kernel's solve on the "
                                 f"widened rows: {[x.tolist() for x in out16]} vs "
                                 f"{[x.tolist() for x in out32]}")
        path_launches[f"{kernel}_bf16"] = launches16[f"{kernel}_bf16"]
        bf16_path[kernel] = dict(lm_iterations=iters, launches=launches16[f"{kernel}_bf16"],
                                 t=out16[0].tolist(), final_cost=float(out16[3]),
                                 solve_ms_median=_wall_ms(lambda: fr._packed_lm_solve(
                                     t_start, q_start, rows16, rate_loss, rate_opts,
                                     planar=planar)[3].item(), 5))
    # float32 against bf16 rows, back to back in turns, at the main path's
    # N and at 1,000,003
    bf16_ab = {}
    for kernel in ck.BF16_ROWS:
        for case in ("fixture_n18712", "ragged_n1000003"):
            packed, poses = bf16_cases[kernel][case]
            widened = ck.lane_aligned(packed.float())
            code, params = params_of(kernel, poses, losses[1])
            calls = {"float32": lambda: partials[kernel](params, widened, code),
                     "bf16": lambda: partials[kernel](params, packed, code)}
            times = {"float32": [], "bf16": []}
            for rows in ("float32", "bf16", "bf16", "float32"):
                times[rows].append(_time_ms(calls[rows], 200)[0])
            bf16_ab[f"{kernel}/n{packed.shape[-1]}"] = {
                f"{k}_ms_back_to_back": v for k, v in times.items()}
    emit("bf16_rows", rtol_of_abs_sum=RTOL, atol=ATOL, bitwise_repeatable=True,
         bitwise_float32_kernel_on_widened_rows=True, zero_padding_invariant=True,
         cases=bf16_report, main_path=bf16_path, order="float32 bf16 bf16 float32",
         ab=bf16_ab, device=name, nvidia_smi=smi)
    # ---- the SE(3) pose graph, float64 (no port kernel on its path) --------
    _pose_graph_reference(dev, name, smi)
    sphere = _pose_graph_sphere2500(dev, name, smi)
    _pose_graph_chain(dev, name, smi)
    # ---- the sparse multifrontal solver, SE(2) and the initializer -------
    _pose_graph_sparse_reference(dev, name, smi)
    _pose_graph_sparse_sphere2500(dev, name, smi)
    m3500 = _pose_graph_m3500(dev, name, smi)
    city = _pose_graph_city10000(dev, name, smi)
    # ---- marginal covariances and batched solves (no port kernel) --------
    _pose_graph_covariance(dev, name, smi, sphere, m3500, city)
    del sphere, m3500, city
    _pose_graph_batch(dev, name, smi)
    # ---- slice 11: the generic PoseOptimizer, sharding, the time checker --
    _problem_generic(dev, name, smi, matched, true_pose)
    _sharded(dev, name, smi, dict(
        matched=matched, planar_matched=planar_matched, reproj_data=reproj_data,
        p2p_matched=p2p_matched, ndt_map=ndt_map, p2p_map=p2p_map, intrinsics=intrinsics,
        local=local, local_planar=local_planar, p2p_start=p2p_start,
    ))
    _time_checker(dev, name, smi, matched)
    # ---- slice 12: the native host pipeline, HybridRegistrar, fixed-lag,
    # the examples ---------------------------------------------------------
    nat_map, nat_scan = _native_pipeline(name, smi, pts, ndt_map, scan, numpy_s)
    slice12_launches = _hybrid_registrar(dev, name, smi, nat_map, nat_scan, true_pose,
                                         planar_pose)
    slice12_launches.update(_fixed_lag(dev, name, smi))
    slice12_launches.update(_examples(dev, name, smi))
    emit("slice12_launches", launches=slice12_launches, device=name, nvidia_smi=smi)
    # ---- slice 13: bundle adjustment, BAL and the pose-landmark
    # optimizers (no port kernel on their path) --------------------------
    _bundle_adjustment(dev, name, smi)
    _bal(dev, name, smi)
    _pose_landmark(dev, name, smi)
    # ---- the inertial stack and the Sim(3) essential graph (no port
    # kernel on their path; gps_ins runs in the examples phase) ----------
    stream = _gps_ins_stream(max(GPS_INS_KEYFRAMES, GPS_INS_SMOOTHER_KEYFRAMES))
    _gps_ins_batch(dev, name, smi, stream)
    _inertial_smoother(dev, name, smi, stream)
    del stream
    _sim3(dev, name, smi)

    kernels = []
    for kernel in (*KERNEL_SHAPE, *(f"{k}_bf16" for k in ck.BF16_ROWS)):
        base = kernel.removesuffix("_bf16")
        kcases = bf16_cases[base] if kernel != base else cases[kernel]
        row = time_kernel(base, *kcases[main_case[base]])
        bytes_ms, flop_ms = row["bytes_ms"], row["flop_ms"]
        kernels.append({
            "name": kernel,
            "route": "cuda",
            "source": f"nonlinear_optimizer_for_slam_tpu_torch/csrc/{base}.cu",
            "replaces": TPU_KERNEL[base],
            "launches": path_launches[kernel],
            "max_abs_err": worst[(kernel, main_case[base], "ExponentialLoss")],
            "ms": row["ms_back_to_back"],
            "plain_ms": row["plain_ms_back_to_back"],
            "bound_ms": max(bytes_ms, flop_ms),
            "bound_by": "bytes" if bytes_ms >= flop_ms else "operations",
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


# The JAX package's solver choice on sphere2500 (select_solver with the RCM
# bandwidth; tests/test_solver_selection.py:34 holds bandwidth < 120 and
# tests/test_torch_pose_graph.py holds the port's choice to JAX's).
SPHERE_SELECTION = {
    "P": 2500, "E": 4899, "d": 7, "n_corr": 2400, "bandwidth": 51,
    "banded_flops": 4549929300.0, "banded_panel_bytes": 50979600,
    "predicted_banded_ms": 26.3883293, "reason": "small superblock flops",
}
CHAIN_POSES = 5000  # tests/test_solver_selection.py:79-89
EXACT_CHAIN_POSES = 2000  # tests/test_pose_graph.py:181-215


def _chain_graph(P: int):
    """tests/test_pose_graph.py's chain: identity rotations, a seeded random
    walk, noisy starts (pose 0 exact and constant), odometry between
    neighbours and three long loops."""
    from nonlinear_optimizer_for_slam_tpu_torch.core.pose import Pose

    rng = np.random.default_rng(2)
    true_pos = np.cumsum(0.2 * rng.normal(size=(P, 3)), axis=0)
    noisy = true_pos + np.where(np.arange(P)[:, None] > 0, 0.05 * rng.normal(size=(P, 3)), 0.0)
    poses = [Pose(np.eye(3), noisy[i]) for i in range(P)]
    edges = [(i, i + 1, Pose(np.eye(3), true_pos[i + 1] - true_pos[i]), False)
             for i in range(P - 1)]
    edges += [(a, b, Pose(np.eye(3), true_pos[b] - true_pos[a]), True)
              for a, b in [(0, P // 2), (P // 4, 3 * P // 4), (10, P - 10)]]
    return poses, edges, true_pos


def _no_port_kernels(phase: str) -> None:
    from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck

    if any(ck.LAUNCHES.values()):
        raise AssertionError(f"{phase}: the pose-graph path launched {ck.LAUNCHES}")


def _pg_state(opt, ids):
    """(positions, quaternions) of the registered poses ``ids``."""
    pos = np.stack([opt.get_pose(i).translation for i in ids])
    quat = np.stack([opt.get_pose(i).quaternion() for i in ids])
    return pos, quat


# LM iterations of the profiled pose-graph solve: enough for the kernels
# per iteration and the idle share, few enough for the profiler's trace.
PROFILED_LM_ITERATIONS = 5


def _pg_timed(opt, initial, options, runs=3):
    """Solve from ``initial`` 1 + ``runs`` times, the first a warm-up (with
    ``runs=0`` one timed solve and no warm-up), the registry reset between
    solves outside the clock; the wall is the median of the timed solves.
    Then torch.profiler over a solve capped at PROFILED_LM_ITERATIONS
    (its reset, a host loop, inside) for the device kernels per LM
    iteration and the idle share. Returns the numbers and the last full
    summary; the optimizer holds a solution of the capped solve."""
    import torch

    import nonlinear_optimizer_for_slam_tpu_torch as port

    options = options or port.Options().replace(max_iterations=500)

    def reset():
        for vid, pose in initial.items():
            opt.set_pose(vid, pose)

    walls = []
    for _ in range(runs + 1):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary, _ = opt.solve(options)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    walls = walls[1:] or walls
    short = options.replace(max_iterations=min(PROFILED_LM_ITERATIONS, options.max_iterations))
    capped = []
    prof = _profile(lambda: (reset(), capped.append(opt.solve(short)[0])), warm=False)
    n_eval = _evaluations([summary])
    wall = statistics.median(walls)
    return dict(
        wall_ms_median=wall, walls_ms=walls, lm_iterations=int(summary.iterations),
        lm_evaluations=n_eval, ms_per_lm_iteration=wall / n_eval,
        profiled_lm_evaluations=_evaluations(capped),
        device_kernels_per_lm_iteration=prof["device_kernels"] / _evaluations(capped),
        device_busy_ms=prof["device_busy_ms"], device_idle_share=prof["device_idle_share"],
        profiled_wall_ms=prof["wall_ms"], top_device=prof["top_device"][:5],
    ), summary


def _pose_graph_reference(dev, name: str, smi: str) -> None:
    """The reference's 80-pose fixture on the card in float64 by every
    solver, against dense and the scipy oracle; first a check that
    ``index_put_`` with ``accumulate=True`` sums repeated indices in one
    order. The pose-graph path runs plain PyTorch ops (no port kernel):
    the kernel counts stay 0."""
    import torch

    from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck
    from nonlinear_optimizer_for_slam_tpu_torch.solvers import pose_graph as pg
    from nonlinear_optimizer_for_slam_tpu_torch.utils import testing

    from scipy.optimize import least_squares

    import nonlinear_optimizer_for_slam_tpu_torch as port
    from nonlinear_optimizer_for_slam_tpu_torch.ops import relative_pose

    f64 = torch.float64
    opts500 = port.Options().replace(max_iterations=500)
    LOOP, ODOM = pg.ConstraintType.LOOP, pg.ConstraintType.ODOMETRY

    # ---- index_put_(accumulate=True) sums repeated indices in one order ----
    srng = np.random.default_rng(SEED + 21)
    idx = torch.as_tensor(srng.integers(0, 2500, 200_000), device=dev)
    vals = torch.as_tensor(srng.normal(size=(200_000, 7, 7)), dtype=f64, device=dev)
    sums = [pg._scatter_add(torch.zeros((2500, 7, 7), dtype=f64, device=dev), idx, vals)
            for _ in range(5)]
    if not all(torch.equal(a, sums[0]) for a in sums[1:]):
        raise AssertionError("pose_graph: index_put_(accumulate=True) is not deterministic")
    host = pg._scatter_add(torch.zeros((2500, 7, 7), dtype=f64), idx.cpu(), vals.cpu())
    scatter_err = float((sums[0].cpu() - host).abs().max())
    if scatter_err > 1e-10:
        raise AssertionError(f"pose_graph: index_put_ on the card vs the host: {scatter_err}")

    # ---- pose_graph_reference: the 80-pose fixture ---------------------------
    ck.reset_launches()
    true, noisy, constraints = testing.generate_pose_graph_fixture()

    def build_ref(penalty=0.03, **kw):
        opt = pg.PoseGraphOptimizer(switch_penalty=penalty, device=dev, **kw)
        for i, p in enumerate(noisy):
            opt.set_pose(i, p)
        opt.set_pose_constant(0)
        for c in constraints:
            opt.set_constraint(c["reference_index"], c["query_index"], c["relative_pose"],
                               LOOP if c["is_loop"] else ODOM)
        return opt

    ref = {}
    for solver in ("dense", "tridiag", "banded", "cg", "auto", "dense_again"):
        opt = build_ref(solver=solver.replace("_again", ""))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary, sw = opt.solve(opts500)
        torch.cuda.synchronize()
        pos, quat = _pg_state(opt, range(80))
        ref[solver] = dict(summary=summary, sw=sw, pos=pos, quat=quat,
                           wall_ms=(time.perf_counter() - t0) * 1e3,
                           choice=opt.last_solver_choice)
    _no_port_kernels("pose_graph_reference")
    dense = ref["dense"]
    if ref["auto"]["choice"] != "dense":
        raise AssertionError(f"pose_graph_reference: auto chose {ref['auto']['choice']}")
    agreement = {}
    for solver, (pose_tol, switch_tol, cost_rtol) in {
        "tridiag": (1e-9, 1e-9, 1e-10), "banded": (1e-9, 1e-9, 1e-10),
        "cg": (5e-4, 5e-3, None), "auto": (0.0, 0.0, 0.0),
    }.items():
        r = ref[solver]
        pose_err = float(max(np.abs(r["pos"] - dense["pos"]).max(),
                             np.abs(r["quat"] - dense["quat"]).max()))
        switch_err = float(np.abs(r["sw"] - dense["sw"]).max())
        cost, cost_d = float(r["summary"].final_cost), float(dense["summary"].final_cost)
        agreement[solver] = dict(pose_max_abs_err=pose_err, switch_max_abs_err=switch_err,
                                 final_cost=cost, lm_iterations=int(r["summary"].iterations))
        if pose_err > pose_tol or switch_err > switch_tol or (
                cost_rtol is not None and abs(cost - cost_d) > cost_rtol * abs(cost_d)):
            raise AssertionError(f"pose_graph_reference: {solver} vs dense: {agreement[solver]}")
    again = ref["dense_again"]
    if not (np.array_equal(again["pos"], dense["pos"]) and np.array_equal(again["quat"], dense["quat"])
            and np.array_equal(again["sw"], dense["sw"])
            and torch.equal(torch.nan_to_num(again["summary"].records.cost),
                            torch.nan_to_num(dense["summary"].records.cost))):
        raise AssertionError("pose_graph_reference: two dense solves differ")
    sw = dense["sw"]
    if not (np.all(sw[:3] >= 0.9) and abs(sw[3]) < 0.1):
        raise AssertionError(f"pose_graph_reference: switches {sw.tolist()}")
    # the scipy oracle on the port's own residual stack, on the host, at the
    # reference's switch penalty (1e-9), as tests/test_pose_graph.py runs it
    oracle, _ = build_ref(penalty=None, solver="dense").solve(opts500)
    is_loop = np.array([1.0 if c["is_loop"] else 0.0 for c in constraints])
    host = lambda a, dt=f64: torch.as_tensor(np.asarray(a), dtype=dt)
    edges = relative_pose.PoseGraphEdges(
        host([c["reference_index"] for c in constraints], torch.long),
        host([c["query_index"] for c in constraints], torch.long),
        host(np.stack([c["relative_pose"].translation for c in constraints])),
        host(np.stack([c["relative_pose"].quaternion() for c in constraints])),
        host(is_loop), torch.ones(len(constraints), dtype=f64),
    )
    loop_slot = np.cumsum(is_loop.astype(int)) - 1
    x0 = np.concatenate([np.stack([p.translation for p in noisy]).ravel(),
                         np.stack([p.quaternion() for p in noisy]).ravel(), np.ones(4)])
    free = np.ones_like(x0, dtype=bool)
    free[:3] = False
    free[240:244] = False

    def residual(x_free):
        x = x0.copy()
        x[free] = x_free
        return relative_pose.edge_residuals(
            host(x[:240].reshape(80, 3)), host(x[240:560].reshape(80, 4)),
            host(x[560:][loop_slot]), edges,
        ).numpy().ravel()

    t0 = time.perf_counter()
    scipy_cost = float(np.sum(least_squares(residual, x0[free], method="lm", xtol=1e-12,
                                            ftol=1e-12).fun ** 2))
    scipy_s = time.perf_counter() - t0
    ours = float(oracle.final_cost)
    if ours > max(1.05 * scipy_cost, 1e-8):
        raise AssertionError(f"pose_graph_reference: cost {ours} vs scipy {scipy_cost}")
    emit("pose_graph_reference", poses=80, edges=len(constraints), loops=4, dtype="float64",
         switch_penalty=0.03, max_iterations=500, auto_choice=ref["auto"]["choice"],
         lm_iterations={k: int(v["summary"].iterations) for k, v in ref.items()},
         final_cost={k: float(v["summary"].final_cost) for k, v in ref.items()},
         wall_ms_one_solve={k: v["wall_ms"] for k, v in ref.items()},
         against_dense=agreement, switches=sw.tolist(), oracle_switch_penalty=1e-9,
         oracle_final_cost=ours, scipy_cost=scipy_cost,
         scipy_s=scipy_s, dense_twice_bitwise=True,
         index_put_accumulate_repeat_bitwise=True, index_put_card_vs_host_max_abs_err=scatter_err,
         port_kernel_launches=0, device=name, nvidia_smi=smi)


def _pose_graph_sphere2500(dev, name: str, smi: str):
    """sphere2500 through the port's g2o writer and reader and
    solver="auto" (banded), against dense at 17,500 unknowns, then CG; ATE
    and RPE of the banded solution (``utils/evaluation.py``). Returns the
    optimizer at the banded solution."""
    import torch

    from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck
    from nonlinear_optimizer_for_slam_tpu_torch.solvers import pose_graph as pg
    from nonlinear_optimizer_for_slam_tpu_torch.utils import testing

    import nonlinear_optimizer_for_slam_tpu_torch as port
    from nonlinear_optimizer_for_slam_tpu_torch.io import g2o

    # ---- pose_graph_sphere2500: g2o round trip, auto, banded vs dense ------
    ck.reset_launches()
    graph, truth = testing.generate_sphere_g2o()
    path = os.path.join(REPO, "build", "sphere2500.g2o")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    g2o.write_g2o(path, graph)
    opt = g2o.load_pose_graph(path, solver="auto", device=dev)
    ids = opt.pose_indices()
    initial = {vid: opt.get_pose(vid) for vid in ids}
    rmse = lambda pos: float(np.sqrt(np.mean(np.sum((pos - truth) ** 2, axis=1))))
    rmse_before = rmse(_pg_state(opt, ids)[0])
    summary, _ = opt.solve()
    if opt.last_solver_choice != "banded" or opt.last_selection != SPHERE_SELECTION:
        raise AssertionError(f"pose_graph_sphere2500: auto chose {opt.last_solver_choice} "
                             f"{opt.last_selection}")
    solved = {vid: opt.get_pose(vid) for vid in ids}
    banded_pos, banded_quat = _pg_state(opt, ids)
    trajectory = _trajectory_errors(
        np.concatenate([banded_pos, banded_quat], axis=1), _sphere_truth(truth), planar=False)
    banded_cost = float(summary.final_cost)
    # one timed solve (the auto solve above warmed it; a median of 3 before,
    # cut with TIMING_RUNS)
    runs = {"banded": dict(final_cost=banded_cost, rmse_after=rmse(banded_pos),
                           **_pg_timed(opt, initial, None, runs=0)[0])}
    # dense: 17,500 unknowns, one timed solve; CG (chain preconditioner,
    # 250 CG iterations a step, about a second an LM iteration here)
    # capped at 10 LM iterations: its inexact steps need not meet the
    # reference's absolute tolerances
    summaries = {"banded": summary}
    for solver, cap in (("dense", 500), ("cg", 10)):
        other = g2o.load_pose_graph(path, solver=solver, device=dev)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        summaries[solver], _ = other.solve(port.Options().replace(max_iterations=cap))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        pos, quat = _pg_state(other, ids)
        n_eval = _evaluations([summaries[solver]])
        runs[solver] = dict(
            final_cost=float(summaries[solver].final_cost), rmse_after=rmse(pos),
            max_iterations=cap, lm_iterations=int(summaries[solver].iterations),
            wall_ms=wall, ms_per_lm_iteration=wall / n_eval, peak_memory_gb=peak_gb,
            position_max_abs_err_vs_banded=float(np.abs(pos - banded_pos).max()),
            quaternion_max_abs_err_vs_banded=float(np.abs(quat - banded_quat).max()),
        )
        # the profile: CG's 20,000-odd kernels an iteration cap it at 2
        for vid, pose in initial.items():
            other.set_pose(vid, pose)
        capped = []
        prof = _profile(lambda: capped.append(other.solve(port.Options().replace(
            max_iterations=PROFILED_LM_ITERATIONS if solver == "dense" else 2))[0]), warm=False)
        runs[solver].update(
            profiled_lm_evaluations=_evaluations(capped),
            device_kernels_per_lm_iteration=prof["device_kernels"] / _evaluations(capped),
            device_idle_share=prof["device_idle_share"], top_device=prof["top_device"][:5])
    # the two exact solvers: the final cost within rtol 1e-10 and the
    # poses within 2e-6. Each solve stops on a step shorter than 1e-6 (the
    # LM parameter tolerance) at the end of a slow tail (199 and 204
    # iterations on the H100), so the two stops agree to about twice that
    # in the worst position; the cost records' spread is reported
    rec_b = summaries["banded"].records.cost.cpu().numpy()
    rec_d = summaries["dense"].records.cost.cpu().numpy()
    n_common = min(_evaluations([summaries["banded"]]), _evaluations([summaries["dense"]]))
    record_err = np.abs(rec_b[:n_common] - rec_d[:n_common]) / rec_d[:n_common]
    d = runs["dense"]
    d["cost_record_rel_err_max"] = float(record_err.max())
    d["cost_record_first_above_1e-10"] = (
        int(np.argmax(record_err > 1e-10)) if (record_err > 1e-10).any() else None)
    if (abs(d["final_cost"] - banded_cost) > 1e-10 * abs(d["final_cost"])
            or max(d["position_max_abs_err_vs_banded"], d["quaternion_max_abs_err_vs_banded"]) > 2e-6):
        raise AssertionError(f"pose_graph_sphere2500: banded {banded_cost} vs dense: {d}")
    if not (runs["banded"]["rmse_after"] < rmse_before and runs["cg"]["rmse_after"] < rmse_before
            and np.isfinite(runs["cg"]["final_cost"])):
        raise AssertionError(f"pose_graph_sphere2500: {runs}")
    _no_port_kernels("pose_graph_sphere2500")
    emit("pose_graph_sphere2500", poses=len(ids), edges=len(graph.edges), dtype="float64",
         auto_choice=opt.last_solver_choice, selection=opt.last_selection,
         dense_unknowns=7 * len(ids), rmse_before=rmse_before, solvers=runs,
         banded_trajectory_errors=trajectory,
         port_kernel_launches=0, device=name, nvidia_smi=smi)
    for vid, pose in solved.items():  # back to the banded solution
        opt.set_pose(vid, pose)
    return opt


def _pose_graph_chain(dev, name: str, smi: str) -> None:
    """The 5,000-pose chain by solver="auto" (tridiag), timed; then the
    2,000-pose chain by tridiag against dense."""
    import torch

    from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck
    from nonlinear_optimizer_for_slam_tpu_torch.solvers import pose_graph as pg
    from nonlinear_optimizer_for_slam_tpu_torch.utils import testing

    import nonlinear_optimizer_for_slam_tpu_torch as port

    LOOP, ODOM = pg.ConstraintType.LOOP, pg.ConstraintType.ODOMETRY

    # ---- pose_graph_chain: 5,000 poses, 3 long loops; tridiag vs dense -----
    ck.reset_launches()

    def build_chain(P, **kw):
        poses, edges, true_pos = _chain_graph(P)
        opt = pg.PoseGraphOptimizer(switch_penalty=0.03, device=dev, **kw)
        for i, p in enumerate(poses):
            opt.set_pose(i, p)
        opt.set_pose_constant(0)
        for a, b, rel, loop in edges:
            opt.set_constraint(a, b, rel, LOOP if loop else ODOM)
        return opt, {i: p for i, p in enumerate(poses)}, true_pos

    opt, initial, true_pos = build_chain(CHAIN_POSES, solver="auto")
    rmse = lambda pos: float(np.sqrt(np.mean(np.sum((pos - true_pos) ** 2, axis=1))))
    rmse_before = rmse(_pg_state(opt, range(CHAIN_POSES))[0])
    summary, _ = opt.solve()
    if opt.last_solver_choice != "tridiag":
        raise AssertionError(f"pose_graph_chain: auto chose {opt.last_solver_choice}")
    chain = dict(final_cost=float(summary.final_cost), rmse_before=rmse_before,
                 rmse_after=rmse(_pg_state(opt, range(CHAIN_POSES))[0]),
                 **_pg_timed(opt, initial, None)[0])
    # exactness: the 2,000-pose chain (14,003 unknowns), 30 iterations.
    # Its measurements are exact and its rotations the identity, so its
    # optimum costs 0 and every quaternion's w direction is held by the
    # 1e-8 floor alone: the two factorizations part by ~1e-9 in the poses
    # from the first step on, which moves the small costs of later
    # iterations by ~1e-5 relative (a 600-pose run on the host). Held:
    # counts equal, poses within 1e-8, the final cost within 1e-10
    # relative plus 1e-12 at the zero floor; the records' spread reported
    exact = {}
    for solver in ("tridiag", "dense"):
        o, initial, true_pos = build_chain(EXACT_CHAIN_POSES, solver=solver)
        s_o, _ = o.solve(port.Options().replace(max_iterations=30))
        exact[solver] = (s_o, _pg_state(o, range(EXACT_CHAIN_POSES)))
    (s_t, st_t), (s_d, st_d) = exact["tridiag"], exact["dense"]
    # and tests/test_block_tridiag.py's own bounds for this chain
    start = np.stack([initial[i].translation for i in range(EXACT_CHAIN_POSES)])
    err_before = float(np.linalg.norm(start - true_pos, axis=1).max())
    err_after = float(np.linalg.norm(st_t[0] - true_pos, axis=1).max())
    c_t, c_d = float(s_t.final_cost), float(s_d.final_cost)
    rec_t, rec_d = s_t.records.cost.cpu().numpy(), s_d.records.cost.cpu().numpy()
    above = np.nan_to_num(rec_d) > 1e-6
    record_err = float(np.max(np.abs(rec_t[above] - rec_d[above]) / rec_d[above]))
    exact_err = float(max(np.abs(a - b).max() for a, b in zip(st_t, st_d)))
    if (int(s_t.iterations) != int(s_d.iterations) or c_t >= 1e-8
            or err_after >= 0.02 * err_before
            or abs(c_t - c_d) > 1e-10 * abs(c_d) + 1e-12 or exact_err > 1e-8):
        raise AssertionError(f"pose_graph_chain: tridiag {c_t} vs dense {c_d}, cost records "
                             f"{record_err}, poses {exact_err}")
    _no_port_kernels("pose_graph_chain")
    emit("pose_graph_chain", poses=CHAIN_POSES, edges=CHAIN_POSES + 2, loops=3, dtype="float64",
         auto_choice=opt.last_solver_choice, selection=opt.last_selection, tridiag=chain,
         exact_check=dict(poses=EXACT_CHAIN_POSES, unknowns=7 * EXACT_CHAIN_POSES + 3,
                          max_iterations=30, final_cost_tridiag=c_t, final_cost_dense=c_d,
                          lm_iterations_tridiag=int(s_t.iterations),
                          lm_iterations_dense=int(s_d.iterations),
                          cost_records_checked=int(above.sum()),
                          cost_record_max_rel_err=record_err, pose_max_abs_err=exact_err,
                          max_error_before=err_before, max_error_after=err_after),
         port_kernel_launches=0, device=name, nvidia_smi=smi)


# The M3500 flow and the 10,000-pose city (tests/test_solver_selection.py:
# 54-69 and 160-180): generate_manhattan_g2o() defaults, and the city at
# n_poses=10000, arena=17, seed=11.
M3500 = dict()
CITY = dict(n_poses=10000, arena=17, seed=11)
# LM iterations of each timed city solve: the city's sparse and banded
# solves run under this cap so that the phase fits the smoke's time.
CITY_LM_ITERATIONS = 10
# M3500's sparse solve against banded and dense from one initialization:
# the final costs within rtol 1e-10 and the poses within this bound.
M3500_POSE_TOL = 1e-6


def _pg2d_state(opt):
    return np.stack([opt.get_pose(i) for i in opt.pose_indices()])


def _pg_solve_timed(opt, options):
    """One solve, its wall (ms, host clock to a synchronise) and the
    solve's peak device memory in GB above what was allocated before it
    (earlier phases leave tensors allocated)."""
    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    summary, sw = opt.solve(options)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return summary, sw, wall, (torch.cuda.max_memory_allocated() - before) / 1e9


def _pose_graph_sparse_reference(dev, name: str, smi: str) -> None:
    """The 80-pose fixture by solver="sparse" (the nested-dissection
    multifrontal Cholesky) against dense, with and without Huber, and two
    sparse solves bitwise equal."""
    import torch

    from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck
    from nonlinear_optimizer_for_slam_tpu_torch.solvers import pose_graph as pg
    from nonlinear_optimizer_for_slam_tpu_torch.utils import testing

    import nonlinear_optimizer_for_slam_tpu_torch as port

    ck.reset_launches()
    _, noisy, constraints = testing.generate_pose_graph_fixture()
    LOOP, ODOM = pg.ConstraintType.LOOP, pg.ConstraintType.ODOMETRY

    def build(solver, loss=None):
        opt = pg.PoseGraphOptimizer(switch_penalty=0.03, solver=solver, edge_loss=loss, device=dev)
        for i, p in enumerate(noisy):
            opt.set_pose(i, p)
        opt.set_pose_constant(0)
        for c in constraints:
            opt.set_constraint(c["reference_index"], c["query_index"], c["relative_pose"],
                               LOOP if c["is_loop"] else ODOM)
        return opt

    runs, agreement = {}, {}
    for label, solver, loss in (("dense", "dense", None), ("sparse", "sparse", None),
                                ("sparse_again", "sparse", None),
                                ("dense_huber", "dense", port.HuberLoss(1.0)),
                                ("sparse_huber", "sparse", port.HuberLoss(1.0))):
        opt = build(solver, loss)
        summary, sw, wall, _ = _pg_solve_timed(opt, port.Options().replace(max_iterations=500))
        runs[label] = dict(summary=summary, sw=sw, state=_pg_state(opt, range(80)), wall_ms=wall)
    _no_port_kernels("pose_graph_sparse_reference")
    # the JAX package's sparse-against-dense tolerances
    # (tests/test_pose_graph_sparse.py:166-203)
    for sparse, dense, cost_rtol, tol in (("sparse", "dense", 1e-10, 1e-9),
                                          ("sparse_huber", "dense_huber", 1e-8, 1e-7)):
        s, d = runs[sparse], runs[dense]
        cost_s, cost_d = float(s["summary"].final_cost), float(d["summary"].final_cost)
        pose_err = float(max(np.abs(a - b).max() for a, b in zip(s["state"], d["state"])))
        switch_err = float(np.abs(s["sw"] - d["sw"]).max())
        agreement[sparse] = dict(
            lm_iterations=int(s["summary"].iterations),
            lm_iterations_dense=int(d["summary"].iterations),
            final_cost=cost_s, final_cost_dense=cost_d,
            pose_max_abs_err=pose_err, switch_max_abs_err=switch_err,
            cost_rtol=cost_rtol, tolerance=tol,
        )
        if (int(s["summary"].iterations) != int(d["summary"].iterations)
                or abs(cost_s - cost_d) > cost_rtol * abs(cost_d)
                or pose_err > tol or switch_err > tol):
            raise AssertionError(f"pose_graph_sparse_reference: {sparse} vs dense: {agreement[sparse]}")
    a, b = runs["sparse"], runs["sparse_again"]
    if not (all(np.array_equal(x, y) for x, y in zip(a["state"], b["state"]))
            and np.array_equal(a["sw"], b["sw"])
            and torch.equal(torch.nan_to_num(a["summary"].records.cost),
                            torch.nan_to_num(b["summary"].records.cost))):
        raise AssertionError("pose_graph_sparse_reference: two sparse solves differ")
    sw = runs["sparse"]["sw"]
    if not (np.all(sw[:3] >= 0.9) and abs(sw[3]) < 0.1):
        raise AssertionError(f"pose_graph_sparse_reference: switches {sw.tolist()}")
    emit("pose_graph_sparse_reference", poses=80, edges=len(constraints), loops=4,
         dtype="float64", switch_penalty=0.03, against_dense=agreement,
         wall_ms_one_solve={k: v["wall_ms"] for k, v in runs.items()},
         switches=sw.tolist(), sparse_twice_bitwise=True, port_kernel_launches=0,
         device=name, nvidia_smi=smi)


def _pose_graph_sparse_sphere2500(dev, name: str, smi: str) -> None:
    """sphere2500 by solver="sparse" against banded, as the sphere2500
    phase holds banded against dense."""
    import nonlinear_optimizer_for_slam_tpu_torch as port
    from nonlinear_optimizer_for_slam_tpu_torch.io import g2o
    from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck
    from nonlinear_optimizer_for_slam_tpu_torch.utils import testing

    ck.reset_launches()
    graph, truth = testing.generate_sphere_g2o()
    path = os.path.join(REPO, "build", "sphere2500.g2o")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    g2o.write_g2o(path, graph)
    rmse = lambda pos: float(np.sqrt(np.mean(np.sum((pos - truth) ** 2, axis=1))))
    runs, states, summaries = {}, {}, {}
    for solver in ("sparse", "banded"):
        opt = g2o.load_pose_graph(path, solver=solver, device=dev)
        ids = opt.pose_indices()
        initial = {vid: opt.get_pose(vid) for vid in ids}
        summaries[solver], _, wall, peak = _pg_solve_timed(opt, None)
        states[solver] = _pg_state(opt, ids)
        n_eval = _evaluations([summaries[solver]])
        runs[solver] = dict(
            final_cost=float(summaries[solver].final_cost), rmse_after=rmse(states[solver][0]),
            lm_iterations=int(summaries[solver].iterations), wall_ms=wall,
            ms_per_lm_iteration=wall / n_eval, peak_memory_gb=peak,
        )
        if solver == "sparse":
            plan = opt._flatten()["sparse"]["plan"]
            stats = plan.stats()
            runs[solver].update(plan_levels=stats["levels"], plan_factor_flops=stats["factor_flops"],
                                plan_max_front=stats["max_front"])
            for vid, pose in initial.items():
                opt.set_pose(vid, pose)
            capped = []
            prof = _profile(lambda: capped.append(opt.solve(port.Options().replace(
                max_iterations=PROFILED_LM_ITERATIONS))[0]), warm=False)
            runs[solver].update(
                profiled_lm_evaluations=_evaluations(capped),
                device_kernels_per_lm_iteration=prof["device_kernels"] / _evaluations(capped),
                device_idle_share=prof["device_idle_share"], top_device=prof["top_device"][:5])
    _no_port_kernels("pose_graph_sparse_sphere2500")
    s, b = runs["sparse"], runs["banded"]
    pose_err = float(np.abs(states["sparse"][0] - states["banded"][0]).max())
    quat_err = float(np.abs(states["sparse"][1] - states["banded"][1]).max())
    s.update(position_max_abs_err_vs_banded=pose_err, quaternion_max_abs_err_vs_banded=quat_err)
    # as the sphere2500 phase holds banded against dense: each solve stops
    # on a step under 1e-6 at the end of a slow tail, so the stops agree to
    # about twice that in the worst position
    if abs(s["final_cost"] - b["final_cost"]) > 1e-10 * abs(b["final_cost"]) or max(pose_err, quat_err) > 2e-6:
        raise AssertionError(f"pose_graph_sparse_sphere2500: sparse vs banded: {runs}")
    emit("pose_graph_sparse_sphere2500", poses=len(graph.vertices), edges=len(graph.edges),
         dtype="float64", solvers=runs, port_kernel_launches=0, device=name, nvidia_smi=smi)


def _manhattan_flow(dev, kw: dict, file_name: str):
    """generate_manhattan_g2o(**kw) -> write_g2o -> load_pose_graph
    (solver="auto") -> initialize(method="chordal"). Returns (path, the
    optimizer, the initialized poses, ground truth, timings)."""
    import torch

    from nonlinear_optimizer_for_slam_tpu_torch.io import g2o
    from nonlinear_optimizer_for_slam_tpu_torch.utils import testing

    t0 = time.perf_counter()
    graph, truth = testing.generate_manhattan_g2o(**kw)
    path = os.path.join(REPO, "build", file_name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    g2o.write_g2o(path, graph)
    t1 = time.perf_counter()
    opt = g2o.load_pose_graph(path, solver="auto", device=dev)
    t2 = time.perf_counter()
    opt.initialize(method="chordal")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    initial = {vid: opt.get_pose(vid) for vid in opt.pose_indices()}
    timings = dict(generate_and_write_ms=(t1 - t0) * 1e3, load_ms=(t2 - t1) * 1e3,
                   chordal_init_ms=(t3 - t2) * 1e3)
    return path, graph, opt, initial, truth, timings


def _from(path, solver, initial, dev):
    from nonlinear_optimizer_for_slam_tpu_torch.io import g2o

    opt = g2o.load_pose_graph(path, solver=solver, device=dev)
    for vid, pose in initial.items():
        opt.set_pose(vid, pose)
    return opt


def _pose_graph_m3500(dev, name: str, smi: str):
    """M3500 (Olson's Manhattan world, 3,500 SE(2) poses) through the g2o
    file, the chordal initialization and solver="auto": auto picks sparse;
    the sparse solve against banded and dense (10,500 unknowns) from the
    same initialization; ATE and RPE of the sparse solution. Returns the
    optimizer at the sparse solution."""
    import torch

    import nonlinear_optimizer_for_slam_tpu_torch as port
    from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck

    ck.reset_launches()
    path, graph, opt, initial, truth, timings = _manhattan_flow(dev, M3500, "m3500.g2o")
    P = len(initial)
    err = lambda xyt: np.linalg.norm(xyt[:, :2] - truth[:, :2], axis=1)
    start = np.stack([graph.vertices[k] for k in sorted(graph.vertices)])
    init_err = err(_pg2d_state(opt))
    options = port.Options().replace(max_iterations=500)
    summaries, states, runs = {}, {}, {}
    summaries["sparse"], sw, wall, peak = _pg_solve_timed(opt, options)
    if opt.last_solver_choice != "sparse":
        raise AssertionError(f"pose_graph_m3500: auto chose {opt.last_solver_choice} {opt.last_selection}")
    selection = dict(opt.last_selection)
    states["sparse"] = _pg2d_state(opt)
    solved = {vid: opt.get_pose(vid) for vid in opt.pose_indices()}
    plan = opt._sparse_plan[1]
    timed, _ = _pg_timed(opt, initial, options)
    runs["sparse"] = dict(first_solve_wall_ms=wall, peak_memory_gb=peak, **timed,
                          plan_levels=plan.num_levels, plan_fronts=plan.stats()["fronts"],
                          plan_factor_flops=plan.stats()["factor_flops"])
    for solver in ("banded", "dense"):
        other = _from(path, solver, initial, dev)
        summaries[solver], _, wall, peak = _pg_solve_timed(other, options)
        states[solver] = _pg2d_state(other)
        n_eval = _evaluations([summaries[solver]])
        runs[solver] = dict(wall_ms=wall, ms_per_lm_iteration=wall / n_eval, peak_memory_gb=peak,
                            lm_iterations=int(summaries[solver].iterations))
        if solver == "banded":
            for vid, pose in initial.items():
                other.set_pose(vid, pose)
            capped = []
            prof = _profile(lambda: capped.append(other.solve(options.replace(
                max_iterations=PROFILED_LM_ITERATIONS))[0]), warm=False)
            runs[solver].update(
                device_kernels_per_lm_iteration=prof["device_kernels"] / _evaluations(capped),
                device_idle_share=prof["device_idle_share"], top_device=prof["top_device"][:5])
    _no_port_kernels("pose_graph_m3500")
    against = {}
    cost_s = float(summaries["sparse"].final_cost)
    rec_s = summaries["sparse"].records.cost.cpu().numpy()
    for solver in ("banded", "dense"):
        cost_o = float(summaries[solver].final_cost)
        rec_o = summaries[solver].records.cost.cpu().numpy()
        n_common = min(_evaluations([summaries["sparse"]]), _evaluations([summaries[solver]]))
        against[solver] = dict(
            lm_iterations=int(summaries["sparse"].iterations),
            lm_iterations_other=int(summaries[solver].iterations),
            final_cost=cost_s, final_cost_other=cost_o,
            pose_max_abs_err=float(np.abs(states["sparse"] - states[solver]).max()),
            cost_record_rel_err_max=float(
                (np.abs(rec_s[:n_common] - rec_o[:n_common]) / rec_o[:n_common]).max()),
        )
        a = against[solver]
        if abs(cost_s - cost_o) > 1e-10 * abs(cost_o) or (
                a["pose_max_abs_err"] > M3500_POSE_TOL
                and a["lm_iterations"] == a["lm_iterations_other"]):
            raise AssertionError(f"pose_graph_m3500: sparse vs {solver}: {a}")
    after = err(states["sparse"])
    if not (after.mean() < 0.1 and after.max() < 0.15 * err(start).max()):
        raise AssertionError(f"pose_graph_m3500: error against the truth {after.mean()} {after.max()}")
    emit("pose_graph_m3500", poses=P, edges=len(graph.edges), dtype="float64",
         flow="write_g2o -> load_pose_graph(solver='auto') -> initialize('chordal') -> solve()",
         auto_choice="sparse", selection=selection, **timings,
         error_before_mean_m=float(err(start).mean()), error_init_mean_m=float(init_err.mean()),
         error_after_mean_m=float(after.mean()), error_after_max_m=float(after.max()),
         lm_iterations={k: int(v.iterations) for k, v in summaries.items()},
         measured_ms_per_lm_iteration={k: v["ms_per_lm_iteration"] for k, v in runs.items()},
         predicted_ms_per_lm_iteration={"sparse": selection["predicted_sparse_ms"],
                                        "banded": selection["predicted_banded_ms"]},
         solvers=runs, sparse_against=against, dense_unknowns=3 * P,
         sparse_trajectory_errors=_trajectory_errors(states["sparse"], truth, planar=True),
         port_kernel_launches=0, device=name, nvidia_smi=smi)
    for vid, xyt in solved.items():  # back to the sparse solution
        opt.set_pose(vid, xyt)
    return opt


def _pose_graph_city10000(dev, name: str, smi: str):
    """The 10,000-pose city through the same flow: auto picks sparse; the
    sparse and banded solves timed under CITY_LM_ITERATIONS LM iterations
    from the same initialization. Returns the optimizer at its capped
    sparse solution."""
    import nonlinear_optimizer_for_slam_tpu_torch as port
    from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck

    ck.reset_launches()
    path, graph, opt, initial, truth, timings = _manhattan_flow(dev, CITY, "city10000.g2o")
    capped = port.Options().replace(max_iterations=CITY_LM_ITERATIONS)
    summaries, runs = {}, {}
    summaries["sparse"], _, wall, peak = _pg_solve_timed(opt, capped)
    if opt.last_solver_choice != "sparse":
        raise AssertionError(f"pose_graph_city10000: auto chose {opt.last_solver_choice} {opt.last_selection}")
    solved = {vid: opt.get_pose(vid) for vid in opt.pose_indices()}
    selection = dict(opt.last_selection)
    plan = opt._sparse_plan[1]
    timed, _ = _pg_timed(opt, initial, capped, runs=1)
    runs["sparse"] = dict(first_solve_wall_ms=wall, peak_memory_gb=peak, **timed,
                          plan_levels=plan.num_levels, plan_factor_flops=plan.stats()["factor_flops"])
    other = _from(path, "banded", initial, dev)
    summaries["banded"], _, wall, peak = _pg_solve_timed(other, capped)
    n_eval = _evaluations([summaries["banded"]])
    runs["banded"] = dict(wall_ms=wall, ms_per_lm_iteration=wall / n_eval, peak_memory_gb=peak,
                          lm_iterations=int(summaries["banded"].iterations))
    _no_port_kernels("pose_graph_city10000")
    rec = {k: v.records.cost.cpu().numpy() for k, v in summaries.items()}
    n_common = min(_evaluations([summaries["sparse"]]), n_eval)
    record_err = float((np.abs(rec["sparse"][:n_common] - rec["banded"][:n_common])
                        / rec["banded"][:n_common]).max())
    if not (np.isfinite(float(summaries["sparse"].final_cost)) and record_err < 1e-8):
        raise AssertionError(f"pose_graph_city10000: sparse vs banded records {record_err}")
    emit("pose_graph_city10000", poses=len(initial), edges=len(graph.edges), dtype="float64",
         auto_choice="sparse", selection=selection, max_iterations=CITY_LM_ITERATIONS, **timings,
         lm_iterations={k: int(v.iterations) for k, v in summaries.items()},
         final_cost={k: float(v.final_cost) for k, v in summaries.items()},
         cost_record_rel_err_max_sparse_vs_banded=record_err,
         measured_ms_per_lm_iteration={k: v["ms_per_lm_iteration"] for k, v in runs.items()},
         predicted_ms_per_lm_iteration={"sparse": selection["predicted_sparse_ms"],
                                        "banded": selection["predicted_banded_ms"]},
         solvers=runs, port_kernel_launches=0, device=name, nvidia_smi=smi)
    for vid, xyt in solved.items():  # back to the capped sparse solution
        opt.set_pose(vid, xyt)
    return opt


def _sphere_truth(pos):
    """(N, 7) [t, q] ground truth of ``generate_sphere_g2o`` from its
    positions: the generator's frames (z along the outward normal, x along
    the travel, y completing the frame)."""
    from nonlinear_optimizer_for_slam_tpu_torch.core.pose import np_rotmat_to_quat_batch

    n = len(pos)
    k = np.arange(n)
    z = pos / np.linalg.norm(pos, axis=1, keepdims=True)
    t = pos[np.minimum(k + 1, n - 1)] - pos[np.maximum(k - 1, 0)]
    x = t - np.sum(t * z, axis=1, keepdims=True) * z
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    R = np.stack([x, np.cross(z, x), z], axis=2)
    return np.concatenate([pos, np_rotmat_to_quat_batch(R)], axis=1)


def _trajectory_errors(est, truth, planar: bool) -> dict:
    """ATE (after a rigid alignment) and one-step RPE of an estimate
    against the truth through the port's ``utils/evaluation.py``: (N, 7)
    [t, q] arrays, or (N, 3) SE(2) xyt arrays with ``planar``."""
    from nonlinear_optimizer_for_slam_tpu_torch.utils import evaluation

    return dict(ate_m=evaluation.absolute_trajectory_error(est, truth, planar=planar),
                rpe=evaluation.relative_pose_error(est, truth, delta=1))


# Marginal covariances by two methods agree within this share of each
# block's largest entry (tests/test_torch_covariance.py holds the port's
# dense, banded and sparse blocks to rtol 1e-9).
COV_RTOL = 1e-9


def _block_diff(got: dict, want: dict) -> float:
    """Largest |got - want| over the blocks, each relative to the largest
    entry of its block in ``want``."""
    return max(float(np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-300))
               for k in want)


def _covariances(opt, methods) -> tuple:
    """``opt.covariance(method=m)`` for each method, with its wall (ms,
    host clock to a synchronise) and peak device memory (GB above what was
    allocated before it). "auto" is named by the method whose blocks it
    returned bit for bit."""
    import torch

    covs, runs = {}, {}
    for method in methods:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        covs[method] = opt.covariance(method=method)
        torch.cuda.synchronize()
        runs[method] = dict(wall_ms=(time.perf_counter() - t0) * 1e3,
                            peak_memory_gb=(torch.cuda.max_memory_allocated() - before) / 1e9)
    if "auto" in covs:
        same = [m for m in methods if m != "auto"
                and all(np.array_equal(covs["auto"][k], covs[m][k]) for k in covs[m])]
        runs["auto"]["chose"] = same[0] if same else None
    return covs, runs


def _pose_graph_covariance(dev, name: str, smi: str, sphere, m3500, city) -> None:
    """Marginal covariances in float64 (plain PyTorch ops, no port kernel):
    the 80-pose fixture by dense, banded and sparse; sphere2500 at its
    banded solution by auto, banded and sparse against dense at 15,000
    unknowns; M3500 at its sparse solution by auto, banded, sparse and
    dense (10,500 unknowns); the 10,000-pose city by auto, banded and
    sparse, with no dense. Each agrees with the last named within COV_RTOL
    of each block's largest entry."""
    from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck
    from nonlinear_optimizer_for_slam_tpu_torch.solvers import pose_graph as pg
    from nonlinear_optimizer_for_slam_tpu_torch.utils import testing

    ck.reset_launches()
    LOOP, ODOM = pg.ConstraintType.LOOP, pg.ConstraintType.ODOMETRY
    _, noisy, constraints = testing.generate_pose_graph_fixture()
    fixture = pg.PoseGraphOptimizer(switch_penalty=0.03, device=dev)
    for i, p in enumerate(noisy):
        fixture.set_pose(i, p)
    fixture.set_pose_constant(0)
    for c in constraints:
        fixture.set_constraint(c["reference_index"], c["query_index"], c["relative_pose"],
                               LOOP if c["is_loop"] else ODOM)
    fixture.solve()
    graphs = {
        "fixture80": (fixture, ("dense", "banded", "sparse", "auto"), "dense"),
        "sphere2500": (sphere, ("auto", "banded", "sparse", "dense"), "dense"),
        "m3500": (m3500, ("auto", "banded", "sparse", "dense"), "dense"),
        "city10000": (city, ("auto", "banded", "sparse"), "sparse"),
    }
    report, worst = {}, {}
    for graph, (opt, methods, against) in graphs.items():
        covs, runs = _covariances(opt, methods)
        for method in methods:
            if method != against:
                runs[method][f"block_rel_diff_vs_{against}"] = _block_diff(covs[method], covs[against])
        worst[graph] = max(r.get(f"block_rel_diff_vs_{against}", 0.0) for r in runs.values())
        report[graph] = dict(poses=len(covs[against]), methods=runs)
    _no_port_kernels("pose_graph_covariance")
    if max(worst.values()) > COV_RTOL or report["fixture80"]["methods"]["auto"]["chose"] != "dense":
        raise AssertionError(f"pose_graph_covariance: {report}")
    emit("pose_graph_covariance", dtype="float64", block_rel_tol=COV_RTOL,
         worst_block_rel_diff=worst, graphs=report, dense_unknowns={
             "sphere2500": 6 * len(sphere.pose_indices()),
             "m3500": 3 * len(m3500.pose_indices())},
         port_kernel_launches=0, device=name, nvidia_smi=smi)


# The Monte-Carlo oracle of tests/test_pose_graph_batch.py: an 8-pose ring
# with one chord, B = 768 measurement draws at these sigmas, its bounds.
MC_SIGMA_T, MC_SIGMA_R = 0.03, 0.02
MC_BATCH = 768
BATCH_LANES = 256  # the 80-pose fixture's batch
SERIAL_LANES = 16  # of them solved one by one
BATCH_2D_LANES = 32  # the 500-pose SE(2) Manhattan world's batch
SERIAL_2D_LANES = 4
BATCH_POSE_TOL = 1e-9


def _quat_mul(a, q):
    """Hamilton product of (..., 4) wxyz arrays."""
    w1, x1, y1, z1 = np.moveaxis(a, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(q, -1, 0)
    return np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2, w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2, w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2],
                    axis=-1)


def _batch_probe(dev) -> dict:
    """Which ops of a dense pose-graph LM iteration give a system the same
    bits alone and in a batch of BATCH_LANES, at the 80-pose fixture's
    sizes (n = 7 * 80 + 4 = 564 rows, 83 edges): cuSOLVER's potrf against
    potrfBatched, torch's triangular solve of one system against its
    batched kernel, the linearization's small batched matmuls (3x4 by 4x4
    Jacobian chains, 7x7 Gram blocks, a row of 7 by 7x7), and the batched
    ``index_put_(accumulate=True)`` with per-instance offsets, whose stable
    sort must keep each instance's serial order (required)."""
    import torch

    rng = np.random.default_rng(SEED + 41)
    n, B, E = 564, BATCH_LANES, 83
    rand = lambda *shape: torch.as_tensor(rng.normal(size=shape), device=dev)
    same = lambda a, b: bool(torch.equal(a, b))
    A = rand(B, n, n)
    H = A @ A.mT + n * torch.eye(n, dtype=A.dtype, device=dev)
    rhs = rand(B, n)
    batched = torch.linalg.cholesky_ex(H)[0]
    lone = torch.stack([torch.linalg.cholesky_ex(h[None])[0][0] for h in H])
    tri = torch.linalg.solve_triangular(lone, rhs[..., None], upper=False)
    tri_lone = torch.stack([torch.linalg.solve_triangular(f[None], r[None, :, None], upper=False)[0]
                            for f, r in zip(lone, rhs)])
    # what a lone factor and solve per lane would cost against the batch
    timings = {
        "potrfBatched_ms": _wall_ms(lambda: torch.linalg.cholesky_ex(H), 5),
        "potrf_lone_loop_ms": _wall_ms(lambda: [torch.linalg.cholesky_ex(h[None]) for h in H], 5),
        "trsm_batched_ms": _wall_ms(
            lambda: torch.linalg.solve_triangular(lone, rhs[..., None], upper=False), 5),
        "trsm_lone_loop_ms": _wall_ms(lambda: [torch.linalg.solve_triangular(
            f[None], r[None, :, None], upper=False) for f, r in zip(lone, rhs)], 5),
    }
    per_lane = lambda fn, *xs: torch.cat([fn(*(x[b * E:(b + 1) * E] for x in xs)) for b in range(B)])
    J34, D44, J77, r7 = rand(B * E, 3, 4), rand(B * E, 4, 4), rand(B * E, 7, 7), rand(B * E, 7)
    chain = lambda a, b: a @ b
    gram = lambda J: J.mT @ J
    row = lambda J, r: (r[:, None, :] @ J)[:, 0, :]
    idx = torch.as_tensor(rng.integers(0, n * n, E * 225), device=dev)
    vals = rand(B, idx.numel())
    offsets = n * n * torch.arange(B, device=dev)[:, None]
    scattered = torch.zeros(B * n * n, dtype=vals.dtype, device=dev).index_put_(
        ((idx[None] + offsets).reshape(-1),), vals.reshape(-1), accumulate=True).reshape(B, -1)
    scattered_lone = torch.stack([torch.zeros(n * n, dtype=vals.dtype, device=dev).index_put_(
        (idx,), v, accumulate=True) for v in vals])
    probe = dict(
        n=n, batch=B, edges=E, torch=torch.__version__,
        potrf_lone_vs_potrfBatched_bitwise=same(batched, lone),
        potrf_lone_vs_potrfBatched_max_diff=float((batched - lone).abs().max()),
        trsm_lone_vs_batched_bitwise=same(tri, tri_lone),
        trsm_lone_vs_batched_max_diff=float((tri - tri_lone).abs().max()),
        matmul_3x4_4x4_bitwise=same(chain(J34, D44), per_lane(chain, J34, D44)),
        matmul_gram_7x7_bitwise=same(gram(J77), per_lane(gram, J77)),
        matmul_row_7x7_bitwise=same(row(J77, r7), per_lane(row, J77, r7)),
        index_put_offsets_vs_lone_bitwise=same(scattered, scattered_lone),
        **timings,
    )
    if not probe["index_put_offsets_vs_lone_bitwise"]:
        raise AssertionError(f"pose_graph_batch: the batched index_put_ sums an instance in "
                             f"another order than alone: {probe}")
    return probe


def _lanes_against_serial(batch_state, serial_states, batch_counts, serial_counts) -> dict:
    """Counts, and the largest difference and bitwise equality of every
    array, of each serially solved lane against its lane of the batch."""
    diffs = [max(float(np.abs(b - s).max(initial=0.0)) for b, s in zip(batch_state(k), serial_states[k]))
             for k in range(len(serial_states))]
    bitwise = [all(np.array_equal(b, s) for b, s in zip(batch_state(k), serial_states[k]))
               for k in range(len(serial_states))]
    return dict(counts_equal=[int(batch_counts[k]) == int(serial_counts[k])
                              for k in range(len(serial_states))],
                max_abs_diff=max(diffs), lanes_bitwise=int(sum(bitwise)),
                lanes_compared=len(serial_states))


def _pose_graph_batch(dev, name: str, smi: str) -> None:
    """``solve_batch`` in float64 (plain PyTorch ops, no port kernel): the
    80-pose fixture at B = BATCH_LANES with seeded resampled measurements,
    SERIAL_LANES of them solved one by one (every count equal, poses
    within BATCH_POSE_TOL); a 500-pose SE(2) Manhattan world at B =
    BATCH_2D_LANES; the Monte-Carlo ring at B = MC_BATCH to the JAX test's
    bounds; and the batch-invariance probe of the 564-row system. A lane
    is held to its serial solve by counts and BATCH_POSE_TOL; how many
    lanes match bit for bit is reported."""
    import torch

    import nonlinear_optimizer_for_slam_tpu_torch as port
    from nonlinear_optimizer_for_slam_tpu_torch.core.pose import np_axis_angle_to_quat
    from nonlinear_optimizer_for_slam_tpu_torch.io import g2o
    from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck
    from nonlinear_optimizer_for_slam_tpu_torch.solvers import pose_graph as pg
    from nonlinear_optimizer_for_slam_tpu_torch.utils import testing

    ck.reset_launches()
    probe = _batch_probe(dev)
    opts = port.Options().replace(max_iterations=500)
    LOOP, ODOM = pg.ConstraintType.LOOP, pg.ConstraintType.ODOMETRY

    def timed(fn):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, (torch.cuda.max_memory_allocated() - before) / 1e9

    # ---- the 80-pose fixture, B lanes of resampled measurements -----------
    _, noisy, constraints = testing.generate_pose_graph_fixture()
    rng = np.random.default_rng(SEED + 31)
    E = len(constraints)
    t0_ = np.stack([c["relative_pose"].translation for c in constraints])
    R0 = np.stack([c["relative_pose"].rotation for c in constraints])
    lane_t = t0_ + 0.01 * rng.normal(size=(BATCH_LANES, E, 3))
    lane_R = [[R0[e] @ port.Pose.from_quat_trans(np_axis_angle_to_quat(w), None).rotation
               for e, w in enumerate(0.002 * rng.normal(size=(E, 3)))] for _ in range(BATCH_LANES)]
    lane_q = np.stack([[port.Pose(R, t).quaternion() for R, t in zip(Rs, ts)]
                       for Rs, ts in zip(lane_R, lane_t)])

    def build(lane=None):
        opt = pg.PoseGraphOptimizer(switch_penalty=0.03, device=dev)
        for i, p in enumerate(noisy):
            opt.set_pose(i, p)
        opt.set_pose_constant(0)
        for e, c in enumerate(constraints):
            rel = c["relative_pose"] if lane is None else port.Pose(lane_R[lane][e], lane_t[lane, e])
            opt.set_constraint(c["reference_index"], c["query_index"], rel,
                               LOOP if c["is_loop"] else ODOM)
        return opt

    (pos_b, quat_b, sw_b, sum_b), batch_ms, batch_gb = timed(lambda: build().solve_batch(
        relative_translations=lane_t, relative_quaternions=lane_q, options=opts))
    serial, serial_counts, serial_ms = [], [], []
    for lane in range(SERIAL_LANES):
        opt = build(lane)
        (summary, sw), ms, _ = timed(lambda: opt.solve(opts))
        serial.append(_pg_state(opt, range(80)) + (sw,))
        serial_counts.append(int(summary.iterations))
        serial_ms.append(ms)
    # a lane's quaternions through Pose as get_pose() returns them
    via_pose = lambda quat: np.stack([port.Pose.from_quat_trans(q, None).quaternion() for q in quat])
    fixture = _lanes_against_serial(lambda k: (pos_b[k], via_pose(quat_b[k]), sw_b[k]), serial,
                                    sum_b.iterations, serial_counts)
    fixture.update(batch=BATCH_LANES, unknowns=7 * 80 + 4, batch_wall_ms=batch_ms,
                   batch_ms_per_solve=batch_ms / BATCH_LANES, batch_peak_memory_gb=batch_gb,
                   serial_ms_per_solve=statistics.mean(serial_ms),
                   lm_iterations_min_max=[int(sum_b.iterations.min()), int(sum_b.iterations.max())],
                   all_converged=bool(np.all(sum_b.converged)))

    # ---- a 500-pose SE(2) Manhattan world ----------------------------------
    graph, _ = testing.generate_manhattan_g2o(n_poses=500)
    path = os.path.join(REPO, "build", "manhattan500.g2o")
    g2o.write_g2o(path, graph)
    base = g2o.load_pose_graph(path, solver="dense", device=dev)
    base.initialize(method="chordal")
    start = {vid: base.get_pose(vid) for vid in base.pose_indices()}
    cons = base.constraints()
    rel0 = np.stack([c["relative_xyt"] for c in cons])
    rels = rel0[None] + np.array([0.01, 0.01, 0.002]) * rng.normal(size=(BATCH_2D_LANES,) + rel0.shape)
    (xyt_b, sw2_b, sum2_b), batch2_ms, batch2_gb = timed(
        lambda: base.solve_batch(relative_xyt=rels, options=opts))
    serial2, serial2_counts, serial2_ms = [], [], []
    for lane in range(SERIAL_2D_LANES):
        opt = pg.PoseGraphOptimizer2D(switch_penalty=base.switch_penalty, device=dev)
        for vid, xyt in start.items():
            opt.set_pose(vid, xyt)
        for vid in graph.fixed or {min(graph.vertices)}:  # load_pose_graph's gauge
            opt.set_pose_constant(vid)
        for e, c in enumerate(cons):
            opt.set_constraint(c["reference_index"], c["query_index"], rels[lane, e], c["type"],
                               sqrt_info=c["sqrt_info"])
        (summary, sw), ms, _ = timed(lambda: opt.solve(opts))
        serial2.append((_pg2d_state(opt), sw))
        serial2_counts.append(int(summary.iterations))
        serial2_ms.append(ms)
    manhattan = _lanes_against_serial(lambda k: (xyt_b[k], sw2_b[k]), serial2,
                                      sum2_b.iterations, serial2_counts)
    manhattan.update(batch=BATCH_2D_LANES, poses=len(start), edges=len(cons),
                     unknowns=3 * len(start) + sw2_b.shape[1], batch_wall_ms=batch2_ms,
                     batch_ms_per_solve=batch2_ms / BATCH_2D_LANES, batch_peak_memory_gb=batch2_gb,
                     serial_ms_per_solve=statistics.mean(serial2_ms),
                     lm_iterations_min_max=[int(sum2_b.iterations.min()), int(sum2_b.iterations.max())])

    # ---- the Monte-Carlo ring: B = 768 draws against covariance() --------
    P = 8
    ang = 2 * np.pi * np.arange(P) / P
    pos = np.stack([np.cos(ang), np.sin(ang), 0.05 * np.arange(P)], axis=1)
    rots = [port.Pose.from_axis_angle(a, [0.0, 0.0, 1.0]).rotation for a in ang]
    pairs = [(i, i + 1) for i in range(P - 1)] + [(0, 4)]
    rels_mc = [(rots[i].T @ (pos[j] - pos[i]), rots[i].T @ rots[j]) for i, j in pairs]
    ring = pg.PoseGraphOptimizer(device=dev)
    for i in range(P):
        ring.set_pose(i, port.Pose(rots[i], pos[i]))
    ring.set_pose_constant(0)
    for (i, j), (t, R) in zip(pairs, rels_mc):
        ring.set_constraint(i, j, port.Pose(R, t), ODOM,
                            sqrt_info=np.array([1.0 / MC_SIGMA_T, 1.0 / MC_SIGMA_R]))
    mc_opts = port.Options().replace(max_iterations=30)
    ring.solve(mc_opts)
    cov = ring.covariance()
    mrng = np.random.default_rng(42)
    ts = np.empty((MC_BATCH, len(pairs), 3))
    qs = np.empty((MC_BATCH, len(pairs), 4))
    q_rel = np.stack([port.Pose(R, t).quaternion() for t, R in rels_mc])
    t_rel = np.stack([t for t, _ in rels_mc])
    for b in range(MC_BATCH):
        ts[b] = t_rel + MC_SIGMA_T * mrng.standard_normal(t_rel.shape)
        dq = np.stack([np_axis_angle_to_quat(w) for w in MC_SIGMA_R * mrng.standard_normal(t_rel.shape)])
        qs[b] = _quat_mul(q_rel, dq)
    (bpos, bquat, _, bsum), mc_ms, mc_gb = timed(lambda: ring.solve_batch(
        relative_translations=ts, relative_quaternions=qs, options=mc_opts))
    true_q = np.stack([port.Pose(rots[i], pos[i]).quaternion() for i in range(P)])
    monte_carlo = dict(batch=MC_BATCH, all_converged=bool(np.all(bsum.converged)), wall_ms=mc_ms,
                       peak_memory_gb=mc_gb, poses={})
    for i in (3, P - 1):
        qi = bquat[:, i] * np.sign(bquat[:, i, :1])
        conj = true_q[i] * np.array([1.0, -1.0, -1.0, -1.0])
        dth = 2.0 * _quat_mul(np.broadcast_to(conj, qi.shape), qi)[:, 1:]
        x = np.concatenate([bpos[:, i] - pos[i], dth], axis=1)
        x = x - x.mean(axis=0)
        sample = (x.T @ x) / (MC_BATCH - 1)
        ratio = np.diag(sample) / np.diag(cov[i])
        monte_carlo["poses"][i] = dict(
            frobenius_rel_err=float(np.linalg.norm(sample - cov[i]) / np.linalg.norm(cov[i])),
            diag_ratio_min=float(ratio.min()), diag_ratio_max=float(ratio.max()))

    _no_port_kernels("pose_graph_batch")
    failures = []
    for label, lanes in (("fixture80", fixture), ("manhattan500", manhattan)):
        if not all(lanes["counts_equal"]) or lanes["max_abs_diff"] > BATCH_POSE_TOL:
            failures.append(label)
    if not fixture["all_converged"]:
        failures.append("fixture80 converged")
    if not monte_carlo["all_converged"] or any(
            m["frobenius_rel_err"] >= 0.25 or m["diag_ratio_min"] <= 0.75 or m["diag_ratio_max"] >= 1.3
            for m in monte_carlo["poses"].values()):
        failures.append("monte_carlo")
    if failures:
        raise AssertionError(f"pose_graph_batch: {failures}: {fixture} {manhattan} {monte_carlo}")
    emit("pose_graph_batch", dtype="float64", pose_tol=BATCH_POSE_TOL, fixture80=fixture,
         manhattan500=manhattan, monte_carlo=monte_carlo, batch_invariance_probe=probe,
         port_kernel_launches=0, device=name, nvidia_smi=smi)


# ---- slice 11: the generic PoseOptimizer, sharding, the time checker --------

# The generic PoseOptimizer on the card against the same solve on the CPU
# port, both float64: the iteration counts are equal and the poses within
# this bound (the two sum 18,712 float64 factors in different orders).
PROBLEM_POSE_TOL = 1e-9
# Two ranks of one process group on the one card, over gloo (NCCL refuses
# two ranks on one device) with the (H, g, cost) partials staged through
# host memory, and a one-rank NCCL group beside them.
SHARDED_WORLD = 2
# A sharded float32 solve against the unsharded one: the same kernel on
# half the rows a rank, the two partials added after, so the sums round
# otherwise; the counts are equal and the poses within 1e-5 (PR 11's runs
# measured at most 3.7e-7, maha6's minimizer); so for the bundle adjuster
# in float32 (landmarks sharded, the reduced camera system summed). In
# float64 (the pose
# graph): CG's cost within rtol 1e-9 (the JAX test's) and poses 1e-6,
# sparse (whose fronts each rank factors alone or in smaller batches) cost
# rtol 1e-10 and poses 1e-9.
SHARDED_POSE_TOL = {"maha6": 1e-5, "maha3c": 1e-5, "reproj": 1e-5, "p2p": 1e-5,
                    "registrar_maha": 1e-5, "registrar_planar": 1e-5, "registrar_p2p": 1e-5,
                    "cg": 1e-6, "sparse_m3500": 1e-9, "bundle_adjustment": 1e-5}
SHARDED_COST_RTOL = {"cg": 1e-9, "sparse_m3500": 1e-10}


def _problem_generic(dev, name: str, smi: str, matched, true_pose) -> None:
    """``PoseOptimizer`` (float64) on the card over the first outer
    iteration's 18,712 maha-simple correspondences under the exponential
    loss, with translation and rotation priors at the true pose, against
    the same solve on the CPU; then the hand-eye problem of
    tests/test_problem.py (a user-defined functor, Jacobians by
    ``torch.func.jacfwd``). No port kernel: the generic functors run the
    plain factor code, as the JAX package's reach no Pallas kernel."""
    import torch

    import nonlinear_optimizer_for_slam_tpu_torch as port
    from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck
    from nonlinear_optimizer_for_slam_tpu_torch.solvers import problem as gp

    def ndt_problem(device):
        problem = gp.Problem()
        problem.add_residual_block(
            gp.MahalanobisDistanceCostFunctor(matched.points, matched.means, matched.sqrt_infos,
                                              matched.mask, device=device),
            port.ExponentialLoss(1.0, 1.0),
        )
        problem.add_residual_block(
            gp.TranslationDeltaCostFunctor(true_pose.translation, np.eye(3), device=device))
        problem.add_residual_block(
            gp.RotationDeltaCostFunctor(true_pose.rotation, np.eye(3), device=device))
        return problem

    def solve_both(make, options):
        on_card = gp.PoseOptimizer(device=dev)
        problem = make(dev)
        pose, summary = on_card.solve(problem, options, port.Pose.identity())
        cpu_pose, cpu_summary = gp.PoseOptimizer(device="cpu").solve(
            make("cpu"), options, port.Pose.identity())
        diff = float(np.abs(pose.matrix() - cpu_pose.matrix()).max())
        if int(summary.iterations) != int(cpu_summary.iterations) or diff > PROBLEM_POSE_TOL:
            raise AssertionError(
                f"problem_generic: card {int(summary.iterations)} iterations, CPU "
                f"{int(cpu_summary.iterations)}, pose difference {diff}")
        walls = []  # the first solve above was the warm-up
        for _ in range(5):
            t0 = time.perf_counter()
            on_card.solve(problem, options, port.Pose.identity())
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return pose, summary, diff, walls

    ck.reset_launches()
    options = gp.GenericOptions()
    pose, summary, diff, walls = solve_both(ndt_problem, options)
    # one inner solve on the first outer iteration's correspondences: the
    # check is the CPU solve above; the distance to the true pose is shown
    t_err = float(np.linalg.norm(pose.translation - true_pose.translation))
    if not (bool(summary.converged) and np.isfinite(float(summary.final_cost))):
        raise AssertionError(f"problem_generic: converged {bool(summary.converged)}, "
                             f"cost {float(summary.final_cost)}")
    ndt = dict(correspondences=int(matched.num_factors), iterations=int(summary.iterations),
               final_cost=float(summary.final_cost), t_err_mm=t_err * 1e3,
               pose_vs_cpu=diff, median_ms=statistics.median(walls), min_ms=min(walls),
               max_ms=max(walls), ms_per_iteration=statistics.median(walls)
               / (int(summary.iterations) + 1))

    hand_eye, X = _hand_eye_problem()
    est, he_summary, he_diff, he_walls = solve_both(hand_eye, gp.GenericOptions(max_iterations=100))
    he_err = float(np.abs(est.matrix() - X.matrix()).max())
    if he_err > 1e-8:
        raise AssertionError(f"problem_generic: hand-eye estimate {he_err} from the truth")
    _no_port_kernels("problem_generic")
    emit("problem_generic", dtype="float64", runs=5, ndt_with_priors=ndt,
         hand_eye={"pairs": 30, "iterations": int(he_summary.iterations),
                   "error_vs_truth": he_err, "pose_vs_cpu": he_diff,
                   "median_ms": statistics.median(he_walls)},
         pose_tol=PROBLEM_POSE_TOL, port_kernel_launches=0, device=name, nvidia_smi=smi)


def _hand_eye_problem():
    """tests/test_problem.py's AX = XB calibration: 30 motion pairs from
    seed 0, a chordal residual, Huber 0.05. Returns (a builder of the
    Problem on a device, the true X)."""
    import torch

    import nonlinear_optimizer_for_slam_tpu_torch as port
    from nonlinear_optimizer_for_slam_tpu_torch.solvers import problem as gp

    def exp_so3(w):
        th = np.linalg.norm(w)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
        return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K

    class HandEye(gp.CostFunction):
        def __init__(self, arrays, device):
            self.R_a, self.t_a, self.R_b, self.t_b = (
                torch.as_tensor(a, device=device) for a in arrays)

        def residuals(self, R, t):
            rot = (self.R_a @ R - R @ self.R_b).reshape(len(self.t_a), 9)
            trans = (torch.einsum("nij,j->ni", self.R_a, t) + self.t_a
                     - torch.einsum("ij,nj->ni", R, self.t_b) - t)
            return torch.cat([rot, trans], dim=1)

    rng = np.random.default_rng(0)
    X = port.Pose(exp_so3([0.2, -0.4, 0.7]), np.array([0.12, -0.05, 0.30]))
    R_a = np.stack([exp_so3(rng.uniform(-1.2, 1.2, 3)) for _ in range(30)])
    t_a = rng.uniform(-0.5, 0.5, (30, 3))
    B = [X.inverse() * port.Pose(R_a[k], t_a[k]) * X for k in range(30)]
    arrays = (R_a, t_a, np.stack([b.rotation for b in B]), np.stack([b.translation for b in B]))

    def make(device):
        problem = gp.Problem()
        problem.add_residual_block(HandEye(arrays, device), port.HuberLoss(0.05))
        return problem

    return make, X


def _sharded_inputs(fx: dict, work: str) -> dict:
    """The arrays every rank loads (``inputs.npz`` in ``work``): the
    smoke's correspondences, scan, maps, the M3500 start and the BA rig."""
    arrays = {}
    for key in ("matched", "planar_matched", "reproj_data", "p2p_matched"):
        for field, value in zip(type(fx[key])._fields, fx[key]):
            arrays[f"{key}/{field}"] = value.cpu().numpy()
    for key in ("ndt_map", "p2p_map"):
        for field in ("means", "sqrt_informations", "informations", "counts", "valid"):
            arrays[f"{key}/{field}"] = getattr(fx[key], field)
    intr = fx["intrinsics"]
    arrays["intrinsics"] = np.array([intr.fx, intr.fy, intr.cx, intr.cy, intr.width, intr.height],
                                    np.float64)
    arrays["local"] = fx["local"]
    arrays["local_planar"] = fx["local_planar"]
    arrays["p2p_start"] = fx["p2p_start"].matrix()
    data, noisy, noisy_lms, _ = _ba_rigs()[0]
    for field, value in zip(data._fields, data):
        arrays[f"ba/{field}"] = value
    arrays["ba/noisy_poses"] = np.stack([p.matrix() for p in noisy])
    arrays["ba/noisy_landmarks"] = noisy_lms
    ids = sorted(fx["m3500_initial"])
    arrays["m3500/ids"] = np.array(ids)
    arrays["m3500/xyt"] = np.stack([fx["m3500_initial"][k] for k in ids])
    np.savez(os.path.join(work, "inputs.npz"), **arrays)
    return arrays


def _sharded_calls(dev, arrays: dict, m3500_path: str, mesh, only=None) -> dict:
    """Every sharded path of the smoke on ``mesh`` (``None``: unsharded),
    or the cases named in ``only``, each with the launch counts set to 0
    just before it and read just after; each call timed after a warm-up
    (CG and sparse: their one run). Returns {case: {numbers and arrays}}."""
    import torch

    import nonlinear_optimizer_for_slam_tpu_torch as port
    from nonlinear_optimizer_for_slam_tpu_torch.io import g2o
    from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck
    from nonlinear_optimizer_for_slam_tpu_torch.ops import mahalanobis, point_to_plane, reprojection
    from nonlinear_optimizer_for_slam_tpu_torch.pipelines import ndt
    from nonlinear_optimizer_for_slam_tpu_torch.solvers import pose_graph as pg
    from nonlinear_optimizer_for_slam_tpu_torch.utils import testing

    on_dev = lambda key, cls: cls(*(torch.as_tensor(arrays[f"{key}/{f}"], device=dev)
                                    for f in cls._fields))
    maps = {key: ndt.NdtMap(*(arrays[f"{key}/{f}"] for f in
                              ("means", "sqrt_informations", "informations", "counts", "valid")))
            for key in ("ndt_map", "p2p_map")}
    fx, fy, cx, cy, width, height = arrays["intrinsics"]
    intrinsics = reprojection.CameraIntrinsics.create(fx, fy, cx, cy, width=int(width),
                                                      height=int(height))
    loss, opts, identity = port.ExponentialLoss(1.0, 1.0), port.Options(), port.Pose.identity()
    size = 1 if mesh is None else mesh.size
    out = {}

    def run(case, kernel, fn, timed=True):
        """``fn() -> (result fields, the count the kernel must equal)``."""
        if only is not None and case not in only:
            return
        if timed:
            fn()
        torch.cuda.synchronize()
        ck.reset_launches()
        t0 = time.perf_counter()
        fields, want = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = {k: v for k, v in ck.LAUNCHES.items() if v}
        if counts != ({kernel: want} if kernel else {}) or (kernel and want == 0):
            raise AssertionError(f"sharded {case}: launches {counts}, want {kernel} = {want}")
        out[case] = dict(fields, launches=want if kernel else 0, wall_ms=wall)

    def minimizer(cls, data, *extra, start=identity):
        # pad_multiple * size: the unsharded solve's padded rows
        m = cls(pad_multiple=1024 // size, device=dev, mesh=mesh).set_loss_function(loss)
        pose, summary = m.solve(opts, data, *extra, start)
        n_eval = int((~torch.isnan(summary.records.cost)).sum())
        return dict(pose=pose.matrix(), iterations=int(summary.iterations),
                    final_cost=float(summary.final_cost), evaluations=n_eval), n_eval

    MD, PD = mahalanobis.MahalanobisData, point_to_plane.PointToPlaneData
    run("maha6", "maha6", lambda: minimizer(port.MahalanobisDistanceMinimizer, on_dev("matched", MD)))
    run("maha3c", "maha3c", lambda: minimizer(port.MahalanobisDistanceMinimizer3DOF,
                                              on_dev("planar_matched", MD)))
    run("reproj", "reproj", lambda: minimizer(port.ReprojectionErrorMinimizer,
                                              on_dev("reproj_data", reprojection.ReprojectionData),
                                              intrinsics))
    p2p_start = port.Pose.from_matrix(arrays["p2p_start"])
    run("p2p", "p2p", lambda: minimizer(port.PointToPlaneMinimizer, on_dev("p2p_matched", PD),
                                        start=p2p_start))

    def register(key, start, scan="local", **kw):
        reg = port.NdtRegistrar(maps[key], opts, loss, device=dev, mesh=mesh, **kw)
        res = reg.register(arrays[scan], start)
        return dict(pose=res.pose.matrix(), outer=res.outer_iterations,
                    inner=res.inner_iterations, final_cost=res.final_cost,
                    **reg.run_stats()), reg.run_stats()["steps"]

    run("registrar_maha", "maha6", lambda: register("ndt_map", identity))
    run("registrar_planar", "maha3", lambda: register("ndt_map", identity, scan="local_planar",
                                                      planar=True))
    run("registrar_p2p", "p2p", lambda: register("p2p_map", p2p_start, objective="p2p",
                                                 max_thickness=0.05))

    def graph_state(opt, summary, switches, poses):
        return dict(iterations=int(summary.iterations), final_cost=float(summary.final_cost),
                    poses=poses, switches=switches), 0

    def cg():
        _, noisy, constraints = testing.generate_pose_graph_fixture()
        opt = pg.PoseGraphOptimizer(switch_penalty=0.03, solver="cg", device=dev, mesh=mesh)
        for i, p in enumerate(noisy):
            opt.set_pose(i, p)
        opt.set_pose_constant(0)
        for c in constraints:
            kind = pg.ConstraintType.LOOP if c["is_loop"] else pg.ConstraintType.ODOMETRY
            opt.set_constraint(c["reference_index"], c["query_index"], c["relative_pose"], kind)
        summary, sw = opt.solve()
        poses = np.stack([np.r_[opt.get_pose(i).translation, opt.get_pose(i).quaternion()]
                          for i in range(80)])
        return graph_state(opt, summary, sw, poses)

    def sparse_m3500():
        opt = g2o.load_pose_graph(m3500_path, solver="sparse", device=dev, mesh=mesh)
        for vid, xyt in zip(arrays["m3500/ids"], arrays["m3500/xyt"]):
            opt.set_pose(int(vid), xyt)
        summary, sw = opt.solve(opts.replace(max_iterations=500))
        return graph_state(opt, summary, sw, _pg2d_state(opt))

    def bundle_adjustment():
        from nonlinear_optimizer_for_slam_tpu_torch.solvers.bundle_adjustment import (
            BAData,
            BundleAdjuster,
        )

        data = BAData(*(arrays[f"ba/{f}"] for f in BAData._fields))
        noisy = [port.Pose.from_matrix(T) for T in arrays["ba/noisy_poses"]]
        # the flat layout, the sharded path's, on both sides
        ba = BundleAdjuster(dtype=torch.float32, layout="flat", device=dev, mesh=mesh)
        poses, lms, s = ba.solve(opts.replace(max_iterations=BA_SMALL_CAP), data,
                                 reprojection.CameraIntrinsics.create(*BA_INTRINSICS), noisy,
                                 arrays["ba/noisy_landmarks"], fixed_cameras=(0, 1))
        return dict(poses=np.stack([p.matrix() for p in poses]), landmarks=lms,
                    iterations=int(s.iterations), final_cost=float(s.final_cost)), 0

    run("cg", None, cg, timed=False)
    run("sparse_m3500", None, sparse_m3500, timed=False)
    run("bundle_adjustment", None, bundle_adjustment)
    return out


def _flat_results(results: dict) -> dict:
    return {f"{case}/{k}": np.asarray(v) for case, fields in results.items()
            for k, v in fields.items()}


def _sharded_rank(rank: int, world: int, work: str) -> None:
    """One rank of the smoke's two-rank world on the one card: join the
    gloo group (``file://`` rendezvous in ``work``), run every sharded path
    over it, and with rank 0 the maha6 minimizer over a one-rank NCCL
    group; write ``rank{rank}.npz`` (or ``rank{rank}.err``)."""
    import traceback

    try:
        sys.path.insert(0, REPO)
        import torch
        import torch.distributed as dist

        from nonlinear_optimizer_for_slam_tpu_torch import parallel

        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", 0)
        dist.init_process_group("gloo", init_method="file://" + os.path.join(work, "rendezvous"),
                                world_size=world, rank=rank)
        try:
            mesh = parallel.make_global_factor_mesh(device=dev)
            if (mesh.size, mesh.rank, mesh.backend, mesh.host_staged) != (world, rank, "gloo", True):
                raise AssertionError(f"rank {rank}: mesh {mesh}, want a gloo world of {world}")
            nccl = dist.new_group(ranks=[0], backend="nccl")
            with np.load(os.path.join(work, "inputs.npz")) as z:
                arrays = {k: z[k] for k in z.files}
            m3500_path = os.path.join(work, "m3500.g2o")
            out = _flat_results(_sharded_calls(dev, arrays, m3500_path, mesh))
            if rank == 0:
                one = parallel.make_factor_mesh(group=nccl, device=dev)
                if (one.size, one.backend) != (1, "nccl"):
                    raise AssertionError(f"rank 0: the NCCL mesh {one}")
                alone = _sharded_calls(dev, arrays, m3500_path, one, only=("maha6",))
                out.update({f"nccl1/{k}": v for k, v in _flat_results(alone).items()})
            dist.barrier()
        finally:
            dist.destroy_process_group()
        np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    except BaseException:
        with open(os.path.join(work, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _sharded(dev, name: str, smi: str, fx: dict) -> None:
    """Two ranks on the one H100, spawned (CUDA does not survive a fork),
    over gloo with host-staged partials: the maha6 minimizer on the 19,456
    padded rows (9,728 a rank), the 3-DoF, PnP and p2p minimizers, the
    NdtRegistrar (maha, planar and p2p) on the full scan, CG on the 80-pose fixture
    and sparse on M3500, each against the same unsharded call in this
    process; the bundle adjuster (float32, flat) on run_all.py's
    300-landmark rig; and a one-rank NCCL group's maha6 solve, bitwise the
    unsharded one. The kernels were built before the spawn, so the ranks
    only load them."""
    import shutil

    import torch.multiprocessing as mp

    work = os.path.join(REPO, "build", "smoke_sharded")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    # M3500 written as g2o and initialized by chordal averaging, as in
    # the pose_graph_m3500 phase; every rank starts from this state
    m3500_path, _, _, initial, _, _ = _manhattan_flow(dev, M3500, "smoke_sharded/m3500.g2o")
    arrays = _sharded_inputs(dict(fx, m3500_initial=initial), work)
    want = _sharded_calls(dev, arrays, m3500_path, None)

    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_sharded_rank, args=(r, SHARDED_WORLD, work))
             for r in range(SHARDED_WORLD)]
    for proc in procs:
        proc.start()
    for proc in procs:
        proc.join(timeout=600)
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join()
    world_s = time.perf_counter() - t0
    errors = [open(os.path.join(work, f)).read() for f in sorted(os.listdir(work))
              if f.endswith(".err")]
    if errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"sharded: ranks exited {[p.exitcode for p in procs]}:\n"
                             + "\n".join(errors))
    ranks = []
    for r in range(SHARDED_WORLD):
        with np.load(os.path.join(work, f"rank{r}.npz")) as z:
            ranks.append({k: z[k] for k in z.files})

    # every rank holds the same bits: the fixed-order sum
    for r, got in enumerate(ranks[1:], 1):
        for k, v in ranks[0].items():
            if not k.startswith("nccl1/") and not k.endswith("wall_ms") and not np.array_equal(got[k], v):
                raise AssertionError(f"sharded: rank {r} differs from rank 0 in {k}")
    report, failures = {}, []
    for case, ref in want.items():
        got = {k[len(case) + 1:]: v for k, v in ranks[0].items() if k.startswith(case + "/")}
        counts = ("iterations",) if "iterations" in ref else ("outer", "inner")
        counts_equal = all(np.array_equal(got[c], ref[c]) for c in counts)
        pose_key = "pose" if "pose" in ref else "poses"
        diff = float(np.abs(got[pose_key] - ref[pose_key]).max())
        row = {"counts": {c: np.asarray(got[c]).tolist() for c in counts},
               "counts_equal_unsharded": counts_equal, "pose_diff_vs_unsharded": diff,
               "launches_per_rank": [int(rk[f"{case}/launches"]) for rk in ranks],
               "wall_ms_per_rank": [float(rk[f"{case}/wall_ms"]) for rk in ranks],
               "unsharded_wall_ms": ref["wall_ms"], "unsharded_launches": ref["launches"]}
        if "evaluations" in ref:
            row["lm_evaluations"] = int(got["evaluations"])
        if "steps" in ref:
            row["steps"] = int(got["steps"])
        if case in SHARDED_COST_RTOL:
            rel = abs(float(got["final_cost"]) - ref["final_cost"]) / abs(ref["final_cost"])
            row["cost_rel_diff"] = rel
            if rel > SHARDED_COST_RTOL[case]:
                failures.append(f"{case}: cost {rel}")
        if not counts_equal or diff > SHARDED_POSE_TOL[case]:
            failures.append(f"{case}: counts {row['counts']} vs unsharded "
                            f"{ {c: np.asarray(ref[c]).tolist() for c in counts} }, pose {diff}")
        report[case] = row
    nccl = {k[len("nccl1/maha6/"):]: v for k, v in ranks[0].items() if k.startswith("nccl1/maha6/")}
    nccl_bitwise = all(np.array_equal(nccl[k], want["maha6"][k])
                       for k in ("pose", "iterations", "final_cost", "evaluations"))
    if not nccl_bitwise or int(nccl["launches"]) != int(nccl["evaluations"]):
        failures.append(f"one-rank NCCL maha6: {nccl} vs unsharded {want['maha6']}")
    if failures:
        raise AssertionError(f"sharded: {failures}")
    emit("sharded", world=SHARDED_WORLD, backend="gloo", staging="host (partials copied to host "
         "memory for the all_gather, the sum in rank order on the host copy, back to the card)",
         start_method="spawn", ranks_bitwise_equal=True, world_wall_s=world_s,
         walls="each call after a warm-up; cg and sparse_m3500 their one first solve "
               "(the sparse plan included)",
         pose_tol=SHARDED_POSE_TOL, cost_rtol=SHARDED_COST_RTOL, cases=report,
         nccl_one_rank={"bitwise_equal_unsharded": True, "iterations": int(nccl["iterations"]),
                        "launches": int(nccl["launches"]), "wall_ms": float(nccl["wall_ms"])},
         device=name, nvidia_smi=smi)


def _time_checker(dev, name: str, smi: str, matched) -> None:
    """``device_time`` around a maha6 kernel solve (the sample includes the
    fence on the card), and ``trace`` writing a torch.profiler trace under
    build/ that exists afterwards and names the span and the kernel."""
    import shutil

    import torch

    import nonlinear_optimizer_for_slam_tpu_torch as port
    from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck
    from nonlinear_optimizer_for_slam_tpu_torch.utils import time_checker as tc

    mini = port.MahalanobisDistanceMinimizer(device=dev).set_loss_function(
        port.ExponentialLoss(1.0, 1.0))
    solve = lambda: mini.solve(port.Options(), matched, port.Pose.identity())[1]
    mgr = tc.TimeCheckerManager.instance()
    mgr.reset()
    solve()
    torch.cuda.synchronize()
    ck.reset_launches()
    with tc.device_time("smoke/maha6_solve") as holder:
        holder["out"] = solve().final_cost
    launches = ck.LAUNCHES["maha6"]
    (sample,) = mgr.samples["smoke/maha6_solve"]
    trace_dir = os.path.join(REPO, "build", "smoke_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    with tc.trace("smoke/maha6_solve", log_dir=trace_dir):
        solve()
        torch.cuda.synchronize()
    files = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    text = open(os.path.join(trace_dir, files[0])).read() if len(files) == 1 else ""
    if not (launches > 0 and sample > 0 and "smoke/maha6_solve" in text and "nls::" in text):
        raise AssertionError(f"time_checker: launches {launches}, sample {sample} ms, "
                             f"trace files {files}")
    emit("time_checker", device_time_ms=sample, maha6_launches=launches,
         report=mgr.report_lines(), trace_file=os.path.relpath(
             os.path.join(trace_dir, files[0]), REPO), trace_bytes=len(text),
         device=name, nvidia_smi=smi)
    mgr.reset()


# ---- slice 12 --------------------------------------------------------------

# tests/test_native.py's tolerance on the information eigenvalues
NATIVE_EIG_RTOL = 1e-8
# HybridRegistrar against NdtRegistrar, as tests/test_native.py:175-186
HYBRID_POSE_TOL = 1e-4
# the fixed-lag window solve on the card against the same updates replayed
# on the CPU port, float64
FIXED_LAG_TOL = 1e-9
RATE_STARTS = 10  # bench.py's pure-rate probe: distinct starts


def _lm_evaluations(inner, outer: int, max_it: int) -> int:
    """LM evaluations of the inner solves from their reported counts: one
    more than the count on a tolerance stop, max_it at the cap."""
    return sum(min(int(i) + 1, max_it) for i in inner[:outer])


def _voxel_order(m):
    """Voxel keys floor(mean / 1 m) of an NDT map, in sorted order, and the
    order that sorts them (the native builder lists voxels in another
    order than numpy's)."""
    keys = np.floor(m.means).astype(np.int64)
    order = np.lexsort(keys.T[::-1])
    return keys[order], order


def _native_pipeline(name: str, smi: str, pts, map_np, scan_np, numpy_s: dict):
    """The port's native build timed from an empty build/torch_native/, then
    ``build_ndt_map`` and ``filter_points`` on the full room, native against
    the numpy copy: the scan equal exactly; voxel keys, counts, validity and
    means equal; the information eigenvalues within NATIVE_EIG_RTOL."""
    import shutil

    from nonlinear_optimizer_for_slam_tpu_torch import native

    shutil.rmtree(native.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    native.ensure_built()
    build_s = time.perf_counter() - t0
    lib = native.load()
    t0 = time.perf_counter()
    m = native.build_ndt_map(pts, 1.0)
    map_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scan = native.filter_points(pts, 0.1)
    filter_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.build_ndt_map(pts, 1.0, num_threads=0)  # threaded: not bitwise
    threaded_s = time.perf_counter() - t0

    keys_nat, o_nat = _voxel_order(m)
    keys_np, o_np = _voxel_order(map_np)
    scan_equal = np.array_equal(scan, scan_np)
    same = (keys_nat.shape == keys_np.shape and np.array_equal(keys_nat, keys_np)
            and np.array_equal(m.counts[o_nat], map_np.counts[o_np])
            and np.array_equal(m.valid[o_nat], map_np.valid[o_np]))
    means_equal = same and np.array_equal(m.means[o_nat], map_np.means[o_np])
    eig_err = float("inf")
    if same:
        e_nat = np.sort(np.linalg.eigvalsh(m.informations[o_nat]), axis=1)
        e_np = np.sort(np.linalg.eigvalsh(map_np.informations[o_np]), axis=1)
        eig_err = float((np.abs(e_nat - e_np) / np.abs(e_np)).max())
    if not (scan_equal and same and means_equal and eig_err <= NATIVE_EIG_RTOL):
        raise AssertionError(
            f"native_pipeline: scan equal {scan_equal}, keys/counts/valid equal {same}, "
            f"means equal {means_equal}, eigenvalue rel err {eig_err}"
        )
    emit(
        "native_pipeline", abi=int(lib.nls_abi_version()), build_s=build_s,
        library=os.path.relpath(str(native.library_path()), REPO),
        points=int(pts.shape[0]), voxels=int(m.num_voxels), valid=int(m.valid.sum()),
        scan=int(scan.shape[0]),
        native={"build_ndt_map_s": map_s, "filter_points_s": filter_s,
                "build_ndt_map_threaded_s": threaded_s, "threads": os.cpu_count()},
        numpy=numpy_s,
        speedup={"build_ndt_map": numpy_s["build_ndt_map_s"] / map_s,
                 "filter_points": numpy_s["filter_points_s"] / filter_s},
        scan_equal=True, keys_counts_valid_equal=True, means_equal=True,
        information_eigenvalue_max_rel_err=eig_err, eig_rtol=NATIVE_EIG_RTOL,
        device=name, nvidia_smi=smi,
    )
    return m, scan


def _hybrid_registrar(dev, name: str, smi: str, nat_map, nat_scan, true_pose,
                      planar_pose) -> dict:
    """``HybridRegistrar`` on the maha-simple scan from the identity (k = 2,
    18,712 lanes): maha6 launches equal to LM evaluations, t_err < 0.05, the
    pose within HYBRID_POSE_TOL of ``NdtRegistrar``'s; the kernel on the
    C++-packed buffer against its plain version; the median of 20 beside
    ``register_ndt`` and ``NdtRegistrar.register``; one outer iteration
    split into matching, upload and LM; the planar variant through maha3;
    bench.py's pure-rate probe (``_packed_lm_solve`` held to 40
    iterations, RATE_STARTS starts). Returns the launches of the paths."""
    import torch

    import nonlinear_optimizer_for_slam_tpu_torch as port
    from nonlinear_optimizer_for_slam_tpu_torch import native
    from nonlinear_optimizer_for_slam_tpu_torch.core.options import ConvergenceHandle
    from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck
    from nonlinear_optimizer_for_slam_tpu_torch.pipelines import fused_registration as fr

    loss = port.ExponentialLoss(1.0, 1.0)
    opts = port.Options()
    max_it = opts.max_iterations
    identity = port.Pose.identity()
    local = true_pose.inverse().apply(nat_scan)
    hyb = fr.HybridRegistrar(nat_map, opts, loss, num_threads=0, device=dev)
    reg = fr.NdtRegistrar(nat_map, opts, loss, device=dev)
    minimizer = port.MahalanobisDistanceMinimizer(device=dev).set_loss_function(loss)
    hyb.register(local, identity)  # warm-up: the kernels and the buffers
    torch.cuda.synchronize()
    ck.reset_launches()
    res = hyb.register(local, identity)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    evals = _lm_evaluations(res.inner_iterations, res.outer_iterations, max_it)
    res_reg = reg.register(local, identity)
    t_err = float(np.linalg.norm(res.pose.translation - true_pose.translation))
    dt = float(np.abs(res.pose.translation - res_reg.pose.translation).max())
    dR = float(np.abs(res.pose.rotation - res_reg.pose.rotation).max())
    others = {k: v for k, v in launches.items() if k != "maha6" and v}
    if not (launches["maha6"] == evals > 0 and not others and t_err < 0.05
            and max(dt, dR) < HYBRID_POSE_TOL):
        raise AssertionError(
            f"hybrid_registrar: launches {launches} for {evals} LM evaluations, "
            f"t_err {t_err}, pose vs NdtRegistrar translation {dt} rotation {dR}"
        )

    # one outer iteration at the identity, layer by layer
    valid = nat_map.valid_only()
    nk = local.shape[0] * 2
    lanes = -(-nk // ck.LANE_ALIGN) * ck.LANE_ALIGN
    host = torch.empty((16, lanes), dtype=torch.float32, pin_memory=True)
    dev_buf = torch.empty((16, lanes), dtype=torch.float32, device=dev)
    host_np = host.numpy()
    match = lambda: native.match_and_pack(
        local, np.eye(3), np.zeros(3), valid.means, valid.sqrt_informations, 1.0, 2,
        lanes, out=host_np, num_threads=0,
    )
    match_ms = _wall_ms(match, TIMING_RUNS)
    match()
    upload_ms = _wall_ms(lambda: dev_buf.copy_(host, non_blocking=True), TIMING_RUNS)
    packed = dev_buf[:, :nk]
    t0 = torch.zeros(3, device=dev)
    q0 = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    lm_ms = _wall_ms(lambda: fr._packed_lm_solve(t0, q0, packed, loss, opts)[3].item(),
                     TIMING_RUNS)

    # the kernel on the C++-packed buffer against its plain version
    code, loss_ab = ck.maha6_loss_ab(loss, dev)
    params = ck.maha6_params(torch.eye(3, device=dev), t0, loss_ab)[None]
    got = ck.maha6_partials(params, packed[None], code)
    all_terms = ck.maha6_terms(params, packed[None], code)
    want, scale = all_terms.sum(dim=-1), _error_scale(all_terms)
    err = (got - want).abs()
    if not bool(torch.isfinite(got).all()) or bool((err > RTOL * scale + ATOL).any()):
        raise AssertionError(f"hybrid_registrar: kernel {got.tolist()} vs plain {want.tolist()}")
    real = int(host_np[15].sum())

    walls = {
        "hybrid_register": _walls_ms(lambda: hyb.register(local, identity), TIMING_RUNS),
        "register_ndt": _walls_ms(
            lambda: port.register_ndt(nat_map, local, identity, minimizer, opts), TIMING_RUNS),
        "ndt_registrar_register": _walls_ms(lambda: reg.register(local, identity), TIMING_RUNS),
    }

    # the planar variant through maha3
    local_p = planar_pose.inverse().apply(nat_scan)
    hyb_p = fr.HybridRegistrar(nat_map, opts, loss, planar=True, num_threads=0, device=dev)
    ck.reset_launches()
    res_p = hyb_p.register(local_p, identity)
    torch.cuda.synchronize()
    launches_p = dict(ck.LAUNCHES)
    evals_p = _lm_evaluations(res_p.inner_iterations, res_p.outer_iterations, max_it)
    others_p = {k: v for k, v in launches_p.items() if k != "maha3" and v}
    if not (launches_p["maha3"] == evals_p > 0 and not others_p):
        raise AssertionError(f"hybrid_registrar planar: launches {launches_p} for "
                             f"{evals_p} LM evaluations")
    res_p_reg = fr.NdtRegistrar(nat_map, opts, loss, planar=True, device=dev).register(
        local_p, identity)
    planar_diff = float(np.abs(res_p.pose.matrix() - res_p_reg.pose.matrix()).max())

    # bench.py's pure-rate probe: 40 iterations a solve, distinct starts
    rate_opts = opts.replace(convergence_handle=ConvergenceHandle(0.0, 0.0, 0.0))
    starts = [t0 + torch.tensor([1e-6 * (r + 1), 0.0, 0.0], device=dev)
              for r in range(RATE_STARTS)]
    fr._packed_lm_solve(starts[0], q0, packed, loss, rate_opts)[2].item()
    rate_ms, rate_iters = [], []
    for start in starts:
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out = fr._packed_lm_solve(start, q0, packed, loss, rate_opts)
        rate_iters.append(int(out[2].item()))
        rate_ms.append((time.perf_counter() - t_start) * 1e3)
    if set(rate_iters) != {max_it}:
        raise AssertionError(f"hybrid_registrar rate probe: iterations {rate_iters}")

    emit(
        "hybrid_registrar", lanes=nk, real_lanes=real, buffer_ld=lanes,
        outer=res.outer_iterations, inner=res.inner_iterations[: res.outer_iterations].tolist(),
        lm_evaluations=evals, maha6_launches=launches["maha6"], t_err_mm=t_err * 1e3,
        pose_vs_ndt_registrar={"translation": dt, "rotation": dR, "tol": HYBRID_POSE_TOL},
        final_cost=res.final_cost,
        kernel_vs_plain_max_abs_err=err.max().item(), rtol_of_abs_sum=RTOL, atol=ATOL,
        walls_median_ms={k: statistics.median(v) for k, v in walls.items()},
        walls_min_ms={k: min(v) for k, v in walls.items()}, runs=TIMING_RUNS,
        outer_iteration_split_ms={"match_and_pack": match_ms, "upload": upload_ms,
                                  "lm_solve": lm_ms, "lm_iterations": int(res.inner_iterations[0]),
                                  "match_threads": os.cpu_count()},
        planar={"outer": res_p.outer_iterations,
                "inner": res_p.inner_iterations[: res_p.outer_iterations].tolist(),
                "lm_evaluations": evals_p, "maha3_launches": launches_p["maha3"],
                "pose_vs_ndt_registrar": planar_diff},
        rate_probe={"iterations": max_it, "starts": RATE_STARTS,
                    "median_ms_per_solve": statistics.median(rate_ms), "ms": rate_ms,
                    "iterations_per_s": max_it / (statistics.median(rate_ms) * 1e-3)},
        device=name, nvidia_smi=smi,
    )
    return {"hybrid_maha6": launches["maha6"], "hybrid_planar_maha3": launches_p["maha3"]}


def _fixed_lag(dev, name: str, smi: str) -> dict:
    """``full_slam.main()`` at its defaults on the card, its smoother's
    updates recorded and replayed on the CPU port (window poses and switches
    within FIXED_LAG_TOL after every update, LM counts equal), then
    ``fixed_lag_slam`` blocking and streaming. Returns the launches."""
    import contextlib
    import io

    import torch

    import nonlinear_optimizer_for_slam_tpu_torch as port
    from nonlinear_optimizer_for_slam_tpu_torch.examples import fixed_lag_slam, full_slam
    from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck
    from nonlinear_optimizer_for_slam_tpu_torch.solvers import fixed_lag as fl

    class Recorder(fl.FixedLagSmoother):
        """Records every registry call and, after each update, the window
        state, the LM count and the update's wall time."""

        made = []

        def __init__(self, lag, **kw):
            super().__init__(lag, **kw)
            self.kwargs = dict(lag=lag, **{k: v for k, v in kw.items() if k != "device"})
            self.calls, self.states, self.update_ms = [], [], []
            Recorder.made.append(self)

        def add_pose(self, index, pose):
            self.calls.append(("add_pose", index, pose.copy()))
            super().add_pose(index, pose)

        def add_odometry(self, a, b, rel, sqrt_info=None):
            self.calls.append(("add_odometry", a, b, rel.copy(), sqrt_info))
            super().add_odometry(a, b, rel, sqrt_info)

        def add_loop(self, a, b, rel, sqrt_info=None):
            self.calls.append(("add_loop", a, b, rel.copy(), sqrt_info))
            super().add_loop(a, b, rel, sqrt_info)

        def update(self, options=None):
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            summary = super().update(options)
            torch.cuda.synchronize()
            self.update_ms.append((time.perf_counter() - t_start) * 1e3)
            self.calls.append(("update",))
            self.states.append(_smoother_state(self, summary))
            return summary

    saved = port.solvers.FixedLagSmoother
    port.solvers.FixedLagSmoother = Recorder
    out = io.StringIO()
    try:
        ck.reset_launches()
        t_start = time.perf_counter()
        with contextlib.redirect_stdout(out):
            e_sm, e_od = full_slam.main(device=dev)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t_start
        launches = dict(ck.LAUNCHES)
    finally:
        port.solvers.FixedLagSmoother = saved
    text = out.getvalue()
    (rec,) = Recorder.made
    switch_lines = [l for l in text.splitlines() if "switch after update" in l]
    planted = float(switch_lines[0].split()[-1]) if switch_lines else float("nan")

    # the same updates on the CPU port
    cpu = fl.FixedLagSmoother(device="cpu", **rec.kwargs)
    pose_err = switch_err = 0.0
    counts_equal, k = True, 0
    for call in rec.calls:
        if call[0] == "update":
            got = _smoother_state(cpu, cpu.update())
            want = rec.states[k]
            k += 1
            counts_equal &= got["iterations"] == want["iterations"]
            pose_err = max(pose_err, float(np.abs(got["window"] - want["window"]).max()))
            if want["switches"].size:
                switch_err = max(switch_err,
                                 float(np.abs(got["switches"] - want["switches"]).max()))
        else:
            getattr(cpu, call[0])(*call[1:])
    if not (planted < 0.15 and e_sm < 0.6 * e_od and e_sm < 0.2 and counts_equal
            and max(pose_err, switch_err) <= FIXED_LAG_TOL):
        raise AssertionError(
            f"fixed_lag: planted switch {planted}, error SLAM {e_sm} vs odometry {e_od}, "
            f"CPU replay counts equal {counts_equal}, pose err {pose_err}, "
            f"switch err {switch_err}\n{text[-2000:]}"
        )

    lines = {}
    for mode, argv in (("blocking", []), ("stream", ["--stream"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fixed_lag_slam.main(argv + ["--device", str(dev)])
        got = buf.getvalue().splitlines()
        update = next(l for l in got if "median per-frame update" in l)
        outlier = next(l for l in got if "planted outlier loop switch" in l)
        err_line = next(l for l in got if l.startswith("trajectory error"))
        nums = [float(w) for w in err_line.replace("/", " ").split() if _is_float(w)]
        switch = float(outlier.split("->")[1].split()[0])
        if not (switch < 0.15 and nums[0] < nums[2]):
            raise AssertionError(f"fixed_lag_slam {mode}: {got}")
        lines[mode] = {
            "median_ms_per_update": float(update.split("update")[1].split()[0]),
            "planted_switch": switch, "smoother_mean_m": nums[0], "smoother_max_m": nums[1],
            "dead_reckoning_mean_m": nums[2], "dead_reckoning_max_m": nums[3],
        }
    emit(
        "fixed_lag", full_slam={
            "frames": 48, "scan_points": 1500, "wall_s": wall_s,
            "updates": len(rec.update_ms), "ms_per_update_median": statistics.median(rec.update_ms),
            "ms_per_update_max": max(rec.update_ms),
            "lm_iterations": [s["iterations"] for s in rec.states],
            "lap2_error_m": {"slam": e_sm, "odometry": e_od}, "planted_switch": planted,
            "launches": {k: v for k, v in launches.items() if v},
            "cpu_replay": {"counts_equal": True, "pose_max_abs_err": pose_err,
                           "switch_max_abs_err": switch_err, "tol": FIXED_LAG_TOL},
        },
        fixed_lag_slam=lines, dtype="float64", device=name, nvidia_smi=smi,
    )
    return {"full_slam_" + k: v for k, v in launches.items() if v}


def _smoother_state(sm, summary) -> dict:
    """The window estimates (W, 7), the active loops' switches and the LM
    count of a fixed-lag smoother right after an update."""
    return {
        "window": np.stack([sm._est[i] for i in sm._window]),
        "switches": np.array([l["switch"] for l in sm._loops]),
        "iterations": int(summary.iterations),
    }


def _is_float(word: str) -> bool:
    try:
        float(word)
        return True
    except ValueError:
        return False


# example -> (arguments, the line it must print)
EXAMPLES = {
    "pose_graph_slam": ([], "loop switches (last one is the planted outlier)"),
    "g2o_solve": (["--max-iterations", "60"], "solved in"),
    "hand_eye_calibration": ([], "rotation error:"),
    "ndt_registration": ([], "map builder: native"),
    "serving_batch": ([], "batched registration:"),
    "incremental_mapping": ([], "scan-to-map   error:"),
    "multi_robot_map_merge": ([], "planted false-rendezvous switch:"),
    "bal_solve": ([], "final cost"),
    "gps_ins": ([], "online (lag=6) max error"),
}


def _examples(dev, name: str, smi: str) -> dict:
    """Every example that the phases above do not drive, as a subprocess on
    the card, all at once: exit code 0 and its key line. Then
    ``serving_batch`` in this process, for its launches. Returns them."""
    import contextlib
    import io

    import torch

    from nonlinear_optimizer_for_slam_tpu_torch.examples import serving_batch
    from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck

    out_dir = os.path.join(REPO, "build", "smoke_examples")
    os.makedirs(out_dir, exist_ok=True)
    procs, report = {}, {}
    try:
        for ex, (args, _) in EXAMPLES.items():
            if ex == "g2o_solve":
                args = args + ["-o", os.path.join(out_dir, "solved.g2o")]
            procs[ex] = (time.perf_counter(), subprocess.Popen(
                [sys.executable, "-m", f"nonlinear_optimizer_for_slam_tpu_torch.examples.{ex}",
                 *args, "--device", "cuda"],
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            ))
        for ex, (t_start, proc) in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            key = EXAMPLES[ex][1]
            lines = [l for l in stdout.splitlines() if key in l]
            if proc.returncode != 0 or not lines:
                raise AssertionError(f"example {ex}: rc {proc.returncode}, key line {key!r} "
                                     f"{'found' if lines else 'missing'}\n{stdout[-1500:]}"
                                     f"\n{stderr[-1500:]}")
            report[ex] = {"rc": 0, "wall_s": time.perf_counter() - t_start,
                          "key_line": lines[0], "tail": stdout.splitlines()[-3:]}
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ck.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        serving_batch.main(device=dev)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ck.LAUNCHES.items() if v}
    if not (launches.get("reproj", 0) > 0 and launches.get("maha6", 0) > 0):
        raise AssertionError(f"serving_batch: launches {launches}")
    emit("examples", examples=report, concurrent=len(procs),
         serving_batch_launches=launches, device=name, nvidia_smi=smi)
    return {"serving_batch_" + k: v for k, v in launches.items()}


# ---- slice 13: bundle adjustment, BAL and the pose-landmark optimizers ------

# benchmarks/run_all.py's BA rigs: pinhole intrinsics, the large rig's
# cameras and landmarks, LM caps
BA_INTRINSICS = (525.0, 525.0, 320.0, 240.0, 640, 480)
BA_LARGE_RIG = (100, 10000)
BA_SMALL_CAP, BA_LARGE_CAP = 60, 40
# run_all.py's landmark worlds: 3-D (poses, landmarks, observations a
# pose), the city (poses, landmarks), 2-D (poses, landmarks, observations
# a pose)
LANDMARK_3D, LANDMARK_CITY, LANDMARK_2D = (200, 2000, 25), (5000, 15000), (1000, 300, 8)
# run_all.py's _plateau_opts: the LM stops on a relative best-cost plateau
# (BA and BAL: rtol 1e-6; the pose-landmark worlds: 1e-5, the city 1e-6)
BA_RTOL, LANDMARK_RTOL = 1e-6, 1e-5
# the card against the CPU port in float64: BA's 300-landmark rig (poses
# and landmarks), the BAL 49-7776 final cost, the pose-landmark 3-D world
# (poses and landmarks; also sparse against dense on the card)
BA_CPU_TOL = 1e-9
BAL_CPU_RTOL = 1e-9
LANDMARK_TOL = 1e-8
# BAL shapes: (cameras, points, seed, landmark_chunk, schur, timed runs);
# run_all.py's, 4 observations a point, 30 LM iterations at most
BAL_SHAPES = [
    (49, 7776, 49, None, "dense", 3),
    (128, 20000, 128, 4096, "dense", 3),
    (1200, 40000, 1200, None, "iterative", 1),
    (13682, 100000, 13682, None, "iterative", 1),
]
BAL_CAP, BAL_PCG_ITERATIONS = 30, 60


def _plateau(cap: int, rtol: float):
    import nonlinear_optimizer_for_slam_tpu_torch as port
    from nonlinear_optimizer_for_slam_tpu_torch.core.options import ConvergenceHandle

    return port.Options().replace(
        max_iterations=cap, convergence_handle=ConvergenceHandle(relative_function_tolerance=rtol)
    )


def _ba_rigs():
    """benchmarks/run_all.py's two BA rigs, drawn from its rng (seed 0) in
    its order: the 8-camera arc over 300 landmarks, then 100 cameras
    orbiting 10,000 landmarks with 35 % of the visible ones observed.
    Each rig: (BAData of numpy arrays, noisy poses, noisy landmarks, true
    solver poses)."""
    import nonlinear_optimizer_for_slam_tpu_torch as port
    from nonlinear_optimizer_for_slam_tpu_torch.solvers.bundle_adjustment import BAData

    rng = np.random.default_rng(0)

    def observe(poses, lms, keep=None):
        ci, li, px = [], [], []
        for c, pose in enumerate(poses):
            pc = pose.inverse().apply(lms)
            uv = np.stack([525 * pc[:, 0] / pc[:, 2] + 320, 525 * pc[:, 1] / pc[:, 2] + 240], 1)
            vis = ((pc[:, 2] > 0.5) & (uv[:, 0] >= 0) & (uv[:, 0] < 640) & (uv[:, 1] >= 0)
                   & (uv[:, 1] < 480))
            if keep is not None:
                vis &= rng.uniform(size=len(lms)) < keep
            idx = np.nonzero(vis)[0]
            ci.extend([c] * len(idx))
            li.extend(idx.tolist())
            px.extend(uv[idx].tolist())
        return BAData(np.array(ci, np.int64), np.array(li, np.int64), np.array(px),
                      np.ones(len(ci)))

    def perturb(truth, angle, step):
        noisy = [truth[0].copy(), truth[1].copy()]
        for p in truth[2:]:
            noisy.append(p * port.Pose.from_axis_angle(angle * rng.normal(), rng.normal(size=3),
                                                       step * rng.normal(size=3)))
        return noisy

    C, M = 8, 300
    lms = np.stack([rng.uniform(-2, 2, M), rng.uniform(-1.5, 1.5, M), rng.uniform(4, 8, M)], 1)
    poses = [port.Pose.from_axis_angle(0.05 * (i - C / 2), [0, 1.0, 0],
                                       [0.4 * i - 1.6, 0.05 * i, 0.0]) for i in range(C)]
    data = observe(poses, lms)
    truth = [p.inverse() for p in poses]
    small = (data, perturb(truth, 0.05, 0.05), lms + 0.05 * rng.normal(size=lms.shape), truth)

    C2, M2 = BA_LARGE_RIG
    lms2 = np.stack([rng.uniform(-2, 2, M2), rng.uniform(-2, 2, M2), rng.uniform(-1.5, 1.5, M2)], 1)
    world_from_cam = []
    for i in range(C2):
        ang = 2 * np.pi * i / C2
        center = np.array([8.0 * np.cos(ang), 8.0 * np.sin(ang), 0.3 * np.sin(3 * ang)])
        z = -center / np.linalg.norm(center)
        x = np.cross(np.array([0.0, 0.0, 1.0]), z)
        x /= np.linalg.norm(x)
        world_from_cam.append(port.Pose(np.stack([x, np.cross(z, x), z], 1), center))
    data2 = observe(world_from_cam, lms2, keep=0.35)
    truth2 = [p.inverse() for p in world_from_cam]
    large = (data2, perturb(truth2, 0.01, 0.03), lms2 + 0.03 * rng.normal(size=lms2.shape), truth2)
    return small, large


def _timed_solves(solve, runs: int):
    """``solve()`` once as a warm-up, then ``runs`` times: (the last
    result, walls ms, peak device GB of the first timed solve above what
    was allocated before it)."""
    import torch

    out = solve()
    walls, peak = [], None
    for _ in range(runs):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = solve()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if peak is None:
            peak = (torch.cuda.max_memory_allocated() - before) / 1e9
    return out, walls, peak


def _ba_case(rig, dtype, dev, profile=True, **kw) -> tuple:
    """One BA configuration: timed solves (median of 3), its counts, the
    largest camera translation error against the truth, peak memory, and
    one solve under torch.profiler (device kernels per LM iteration, idle
    share). Returns (row, (poses, landmarks, summary))."""
    from nonlinear_optimizer_for_slam_tpu_torch.ops.reprojection import CameraIntrinsics
    from nonlinear_optimizer_for_slam_tpu_torch.solvers.bundle_adjustment import BundleAdjuster

    data, noisy, noisy_lms, truth = rig
    intr = CameraIntrinsics.create(*BA_INTRINSICS)
    cap = BA_SMALL_CAP if len(noisy) == 8 else BA_LARGE_CAP
    ba = BundleAdjuster(dtype=dtype, device=dev, **kw)
    solve = lambda: ba.solve(_plateau(cap, BA_RTOL), data, intr, noisy, noisy_lms,
                             fixed_cameras=(0, 1))
    (poses, lms, summary), walls, peak = _timed_solves(solve, 3)
    n_eval = _evaluations([summary])
    wall = statistics.median(walls)
    rec = summary.records.cost.cpu().numpy()
    row = dict(
        dtype=str(dtype)[6:], ms_per_solve_median=wall, walls_ms=walls,
        lm_iterations=int(summary.iterations), lm_evaluations=n_eval,
        ms_per_lm_iteration=wall / n_eval, converged=bool(summary.converged),
        initial_cost=float(rec[0]), final_cost=float(summary.final_cost),
        cam_err=max(float(np.linalg.norm(e.translation - t.translation))
                    for e, t in zip(poses, truth)),
        peak_memory_gb=peak,
    )
    if profile:
        prof = _profile(solve)
        row.update(device_kernels_per_lm_iteration=prof["device_kernels"] / n_eval,
                   device_busy_ms=prof["device_busy_ms"],
                   device_idle_share=prof["device_idle_share"], profiled_wall_ms=prof["wall_ms"],
                   top_device=prof["top_device"][:5])
    if not (np.isfinite(row["final_cost"]) and row["final_cost"] <= row["initial_cost"]):
        raise AssertionError(f"bundle_adjustment: {row}")
    return row, (poses, lms, summary)


def _bundle_adjustment(dev, name: str, smi: str) -> None:
    """``BundleAdjuster`` on run_all.py's rigs: the 8-camera, 300-landmark
    rig in float32 and float64 (float64 held against the CPU port: counts
    equal, poses and landmarks within BA_CPU_TOL), and the 100-camera,
    10,000-landmark rig in float32, grouped and flat with landmark_chunk
    1024. No port kernel runs."""
    import torch

    from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck
    from nonlinear_optimizer_for_slam_tpu_torch.ops.reprojection import CameraIntrinsics
    from nonlinear_optimizer_for_slam_tpu_torch.solvers.bundle_adjustment import BundleAdjuster

    t0 = time.perf_counter()
    small, large = _ba_rigs()
    rigs_s = time.perf_counter() - t0
    ck.reset_launches()
    rows = {}
    rows["small_float32"], _ = _ba_case(small, torch.float32, dev)
    rows["small_float64"], (poses, lms, summary) = _ba_case(small, torch.float64, dev)
    data, noisy, noisy_lms, _ = small
    cpu = BundleAdjuster(dtype=torch.float64, device="cpu").solve(
        _plateau(BA_SMALL_CAP, BA_RTOL), data, CameraIntrinsics.create(*BA_INTRINSICS), noisy,
        noisy_lms, fixed_cameras=(0, 1))
    pose_diff = max(float(np.abs(a.matrix() - b.matrix()).max()) for a, b in zip(poses, cpu[0]))
    lm_diff = float(np.abs(lms - cpu[1]).max())
    cpu_counts_equal = int(summary.iterations) == int(cpu[2].iterations)
    rows["large_grouped_float32"], _ = _ba_case(large, torch.float32, dev, layout="grouped")
    rows["large_flat_chunk1024_float32"], _ = _ba_case(large, torch.float32, dev, layout="flat",
                                                       landmark_chunk=1024)
    _no_port_kernels("bundle_adjustment")
    if not (cpu_counts_equal and pose_diff <= BA_CPU_TOL and lm_diff <= BA_CPU_TOL):
        raise AssertionError(f"bundle_adjustment: float64 card vs CPU counts "
                             f"{int(summary.iterations)}/{int(cpu[2].iterations)}, poses "
                             f"{pose_diff}, landmarks {lm_diff}")
    emit("bundle_adjustment", small_rig=dict(cameras=8, landmarks=300,
                                             observations=small[0].num_observations),
         large_rig=dict(cameras=BA_LARGE_RIG[0], landmarks=BA_LARGE_RIG[1],
                        observations=large[0].num_observations),
         rigs_build_s=rigs_s, fixed_cameras=[0, 1], plateau_rtol=BA_RTOL,
         caps={"small": BA_SMALL_CAP, "large": BA_LARGE_CAP}, cases=rows,
         float64_card_vs_cpu=dict(lm_iterations_equal=True, pose_max_diff=pose_diff,
                                  landmark_max_diff=lm_diff, tol=BA_CPU_TOL),
         port_kernel_launches=0, device=name, nvidia_smi=smi)


def _bal(dev, name: str, smi: str) -> None:
    """``solve_bal`` on run_all.py's synthetic BAL shapes (BAL_SHAPES): the
    49-7776 problem dense in float32 and float64 (float64 against the CPU
    port's final cost, rtol BAL_CPU_RTOL), 128 x 20,000 chunked, and the
    1,200 x 40,000 and 13,682 x 100,000 (final/13682) problems by the
    iterative Schur path, float32. The final cost is at most the initial
    cost on every shape. No port kernel runs."""
    import torch

    from nonlinear_optimizer_for_slam_tpu_torch.io import bal as bal_io
    from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck
    from nonlinear_optimizer_for_slam_tpu_torch.solvers import bal as bal_solver

    ck.reset_launches()
    rows = {}
    opts = _plateau(BAL_CAP, BA_RTOL)
    for C, P, seed, chunk, schur, runs in BAL_SHAPES:
        t0 = time.perf_counter()
        problem, _ = bal_io.synthetic_bal_problem(C, P, 4, seed=seed)
        build_s = time.perf_counter() - t0
        for dtype in ((torch.float32, torch.float64) if C == 49 else (torch.float32,)):
            solve = lambda: bal_solver.solve_bal(
                problem, opts, dtype=dtype, landmark_chunk=chunk, schur=schur,
                schur_iterations=BAL_PCG_ITERATIONS, device=dev)
            (solved, summary), walls, peak = _timed_solves(solve, runs)
            initial = bal_solver.bal_cost(problem, dtype=dtype, device=dev)
            final = bal_solver.bal_cost(solved, dtype=dtype, device=dev)
            n_eval = _evaluations([summary])
            wall = statistics.median(walls)
            row = dict(cameras=C, points=P, observations=problem.num_observations,
                       schur=schur, landmark_chunk=chunk, dtype=str(dtype)[6:],
                       ms_per_solve_median=wall, walls_ms=walls,
                       lm_iterations=int(summary.iterations), lm_evaluations=n_eval,
                       ms_per_lm_iteration=wall / n_eval, converged=bool(summary.converged),
                       initial_cost=initial, final_cost=final,
                       summary_final_cost=float(summary.final_cost), peak_memory_gb=peak,
                       problem_build_s=build_s)
            if not (np.isfinite(final) and final <= initial):
                raise AssertionError(f"bal: {row}")
            if C == 49 and dtype == torch.float64:
                cpu, cpu_summary = bal_solver.solve_bal(problem, opts, device="cpu")
                cpu_final = bal_solver.bal_cost(cpu, device="cpu")
                rel = abs(final - cpu_final) / cpu_final
                row.update(cpu_final_cost=cpu_final, cpu_lm_iterations=int(cpu_summary.iterations),
                           final_cost_rel_diff_vs_cpu=rel)
                if rel > BAL_CPU_RTOL:
                    raise AssertionError(f"bal: float64 card {final} vs CPU {cpu_final}")
            rows[f"{C}x{P}_{schur}_{row['dtype']}"] = row
    _no_port_kernels("bal")
    emit("bal", cost_convention="0.5 sum |r|^2 (Ceres)", plateau_rtol=BA_RTOL, cap=BAL_CAP,
         pcg_iterations=BAL_PCG_ITERATIONS, cases=rows, port_kernel_launches=0,
         device=name, nvidia_smi=smi)


def _rotz(th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _landmark_worlds():
    """benchmarks/run_all.py's landmark worlds (bench_slam_extras): the 3-D
    world (200 poses on a circle, 2,000 landmarks, 25 observations a pose)
    and the 2-D world (1,000 poses, 300 landmarks, 8 observations a pose)
    from its rng (seed 12, drawn in its order), and the city (5,000
    poses, 15,000 landmarks, 75,000 observations; seed 1)."""
    from nonlinear_optimizer_for_slam_tpu_torch.core.pose import Pose

    rng = np.random.default_rng(12)
    P3, M3, K3 = LANDMARK_3D
    gt3 = [Pose(_rotz(th), np.array([8 * np.cos(th), 8 * np.sin(th), 0.0]))
           for th in np.linspace(0, 2 * np.pi, P3, endpoint=False)]
    lms3 = rng.uniform(-4.0, 4.0, size=(M3, 3))
    obs3 = []
    for i, pose in enumerate(gt3):
        for j in rng.choice(M3, K3, replace=False):
            z = pose.rotation.T @ (lms3[j] - pose.translation)
            obs3.append((i, int(j), z + rng.normal(0, 0.01, 3)))

    rng5 = np.random.default_rng(1)
    P5, M5 = LANDMARK_CITY
    gt5 = np.cumsum(0.3 * rng5.normal(size=(P5, 3)), axis=0)
    own5 = rng5.integers(0, P5, M5)
    lm5 = gt5[own5] + rng5.uniform(-2, 2, (M5, 3))
    noisy5 = gt5 + np.where(np.arange(P5)[:, None] > 0, 0.05 * rng5.normal(size=(P5, 3)), 0.0)
    lm5_init = lm5 + 0.1 * rng5.normal(size=(M5, 3))
    obs5 = [(i, j, lm5[j] - gt5[i] + 0.01 * rng5.normal(size=3))
            for j in range(M5) for i in range(max(0, own5[j] - 2), min(P5, own5[j] + 3))]

    P2, M2, K2 = LANDMARK_2D
    th2 = np.cumsum(rng.normal(0.006, 0.02, P2))
    xy2 = np.cumsum(0.3 * np.stack([np.cos(th2), np.sin(th2)], 1), axis=0)
    gt2 = np.concatenate([xy2, th2[:, None]], axis=1)
    lm2 = rng.uniform(xy2.min(0) - 2, xy2.max(0) + 2, size=(M2, 2))
    obs2 = []
    for i in range(P2):
        d = np.linalg.norm(lm2 - xy2[i], axis=1)
        for j in np.argsort(d)[:K2]:
            c, s = np.cos(th2[i]), np.sin(th2[i])
            dp = lm2[j] - xy2[i]
            obs2.append((i, int(j), np.array([c * dp[0] + s * dp[1], -s * dp[0] + c * dp[1]])
                         + rng.normal(0, 0.01, 2)))
    return ((gt3, lms3, obs3), (gt5, noisy5, lm5_init, obs5), (gt2, lm2, obs2))


def _landmark_3d(world, dev, **kw):
    """The 3-D world's optimizer (run_all.py's _lm3_solve at its first
    repetition: start noise from seed 101)."""
    import nonlinear_optimizer_for_slam_tpu_torch as port
    from nonlinear_optimizer_for_slam_tpu_torch.core.pose import Pose

    gt, lms, obs = world
    opt = port.PoseLandmarkOptimizer(device=dev, **kw)
    r2 = np.random.default_rng(101)
    for i, p in enumerate(gt):
        opt.set_pose(i, Pose(p.rotation, p.translation + (r2.normal(0, 0.1, 3) if i else 0.0)))
    opt.set_pose_constant(0)
    for j in sorted({j for (_, j, _) in obs}):
        opt.set_landmark(j, lms[j] + r2.normal(0, 0.2, 3))
    for i in range(len(gt) - 1):
        opt.set_constraint(i, i + 1, gt[i].inverse() * gt[i + 1])
    for (i, j, z) in obs:
        opt.set_observation(i, j, z, sqrt_info=10.0)
    return opt


def _landmark_2d(world, dev, **kw):
    """The 2-D world's optimizer (run_all.py's _lm2 at its first
    repetition: start noise from seed 201)."""
    import nonlinear_optimizer_for_slam_tpu_torch as port

    gt, lms, obs = world
    opt = port.PoseLandmark2DOptimizer(device=dev, **kw)
    r2 = np.random.default_rng(201)
    for i in range(len(gt)):
        opt.set_pose(i, gt[i] + (np.concatenate([r2.normal(0, 0.1, 2), [r2.normal(0, 0.03)]])
                                 if i else 0.0))
    opt.set_pose_constant(0)
    for j in sorted({j for (_, j, _) in obs}):
        opt.set_landmark(j, lms[j] + r2.normal(0, 0.3, 2))
    for i in range(len(gt) - 1):
        c, s = np.cos(gt[i, 2]), np.sin(gt[i, 2])
        dp = gt[i + 1, :2] - gt[i, :2]
        dth = (gt[i + 1, 2] - gt[i, 2] + np.pi) % (2 * np.pi) - np.pi
        opt.set_constraint(i, i + 1, [c * dp[0] + s * dp[1], -s * dp[0] + c * dp[1], dth])
    for (i, j, z) in obs:
        opt.set_observation(i, j, z, sqrt_info=10.0)
    return opt


def _landmark_state(opt):
    ids = opt.pose_indices()
    first = opt.get_pose(ids[0])
    poses = np.stack([opt.get_pose(i).matrix() if hasattr(first, "matrix") else opt.get_pose(i)
                      for i in ids])
    return poses, np.stack([opt.get_landmark(j) for j in opt.landmark_indices()])


def _landmark_case(opt, options, t_err, runs=3) -> dict:
    """Solves of ``opt`` from its registered start: the first (which
    builds a sparse plan) timed alone, then ``runs`` more from the same
    start (median); the counts, the largest translation error against the
    truth, peak memory, and one solve under torch.profiler (in float64,
    bitwise the timed one)."""
    import torch

    start_poses = {i: opt.get_pose(i) for i in opt.pose_indices()}
    start_lms = {j: opt.get_landmark(j) for j in opt.landmark_indices()}

    def reset():
        for i, p in start_poses.items():
            opt.set_pose(i, p)
        for j, l in start_lms.items():
            opt.set_landmark(j, l)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary, _ = opt.solve(options)
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    walls, peak = [], None
    for _ in range(runs):
        reset()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        summary, _ = opt.solve(options)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if peak is None:
            peak = (torch.cuda.max_memory_allocated() - before) / 1e9
    n_eval = _evaluations([summary])
    wall = statistics.median(walls) if walls else first
    row = dict(first_solve_ms=first, ms_per_solve_median=wall, walls_ms=walls,
               lm_iterations=int(summary.iterations), lm_evaluations=n_eval,
               ms_per_lm_iteration=wall / n_eval, converged=bool(summary.converged),
               final_cost=float(summary.final_cost), max_t_err=t_err(opt), peak_memory_gb=peak)
    if runs:
        solved = _landmark_state(opt)
        prof = _profile(lambda: (reset(), opt.solve(options)), warm=False)
        row.update(device_kernels_per_lm_iteration=prof["device_kernels"] / n_eval,
                   device_idle_share=prof["device_idle_share"], top_device=prof["top_device"][:3])
        if opt.dtype == torch.float64 and any(
            not np.array_equal(a, b) for a, b in zip(solved, _landmark_state(opt))
        ):
            raise AssertionError("pose_landmark: two float64 solves from one start differ")
    if not np.isfinite(row["final_cost"]):
        raise AssertionError(f"pose_landmark: {row}")
    return row


def _pose_landmark(dev, name: str, smi: str) -> None:
    """The pose-landmark optimizers on run_all.py's worlds: the 3-D world
    (200 poses, 2,000 landmarks) by dense and sparse in float64 (sparse
    against dense on the card and against the CPU port: counts equal,
    poses and landmarks within LANDMARK_TOL), the city (5,000 poses,
    15,000 landmarks) by sparse in float32 with sparse pose and landmark
    covariances (the dense joint inverse, dimension 75,000, cannot run),
    and the 2-D world (1,000 poses, 300 landmarks) by dense and sparse. No
    port kernel runs."""
    import torch

    import nonlinear_optimizer_for_slam_tpu_torch as port
    from nonlinear_optimizer_for_slam_tpu_torch.core.pose import Pose
    from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck

    t0 = time.perf_counter()
    world3, city, world2 = _landmark_worlds()
    worlds_s = time.perf_counter() - t0
    ck.reset_launches()
    gt3 = world3[0]
    err3 = lambda o: max(float(np.linalg.norm(o.get_pose(i).translation - gt3[i].translation))
                         for i in range(len(gt3)))
    opts = _plateau(60, LANDMARK_RTOL)
    rows, states = {}, {}
    for solver in ("dense", "sparse"):
        opt = _landmark_3d(world3, dev, pose_solver=solver)
        rows[f"3d_{solver}_float64"] = _landmark_case(opt, opts, err3)
        states[solver] = _landmark_state(opt)
    cpu = _landmark_3d(world3, "cpu", pose_solver="sparse")
    cpu_summary, _ = cpu.solve(opts)
    checks = {}
    for other, state, its in (("dense", states["dense"], rows["3d_dense_float64"]["lm_iterations"]),
                              ("cpu", _landmark_state(cpu), int(cpu_summary.iterations))):
        diffs = [float(np.abs(a - b).max()) for a, b in zip(states["sparse"], state)]
        checks[f"sparse_vs_{other}"] = dict(
            lm_iterations_equal=its == rows["3d_sparse_float64"]["lm_iterations"],
            pose_max_diff=diffs[0], landmark_max_diff=diffs[1])
        if not (checks[f"sparse_vs_{other}"]["lm_iterations_equal"]
                and max(diffs) <= LANDMARK_TOL):
            raise AssertionError(f"pose_landmark: 3-D sparse vs {other}: {checks}")

    gt5, noisy5, lm5_init, obs5 = city
    t0 = time.perf_counter()
    big = port.PoseLandmarkOptimizer(switch_penalty=0.03, pose_solver="sparse",
                                     dtype=torch.float32, device=dev)
    for i in range(len(gt5)):
        big.set_pose(i, Pose(np.eye(3), noisy5[i]))
    big.set_pose_constant(0)
    for j in range(len(lm5_init)):
        big.set_landmark(j, lm5_init[j])
    for i in range(len(gt5) - 1):
        big.set_constraint(i, i + 1, Pose(np.eye(3), gt5[i + 1] - gt5[i]))
    for (i, j, z) in obs5:
        big.set_observation(i, j, z, sqrt_info=10.0)
    registry_s = time.perf_counter() - t0
    err5 = lambda o: max(float(np.linalg.norm(o.get_pose(i).translation - gt5[i]))
                         for i in range(0, len(gt5), 13))
    rows["city_sparse_float32"] = _landmark_case(big, _plateau(30, 1e-6), err5, runs=1)
    rows["city_sparse_float32"]["registry_build_s"] = registry_s
    t0 = time.perf_counter()
    cov = big.covariance(method="sparse")
    cov_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    lcov = big.landmark_covariance(method="sparse")
    lcov_ms = (time.perf_counter() - t0) * 1e3
    blocks = [cov[i] for i in range(1, len(gt5))] + list(lcov.values())
    if not all(np.all(np.isfinite(b)) and np.all(np.linalg.eigvalsh(b) > 0) for b in blocks):
        raise AssertionError("pose_landmark: city marginals not positive definite")
    rows["city_sparse_float32"].update(
        covariance_sparse_ms=cov_ms, landmark_covariance_sparse_ms=lcov_ms,
        mid_sigma_t=float(np.sqrt(np.trace(cov[len(gt5) // 2][:3, :3]) / 3)))

    gt2 = world2[0]
    err2 = lambda o: max(float(np.linalg.norm(o.get_pose(i)[:2] - gt2[i, :2]))
                         for i in range(0, len(gt2), 7))
    for solver in ("dense", "sparse"):
        rows[f"2d_{solver}_float64"] = _landmark_case(
            _landmark_2d(world2, dev, pose_solver=solver), opts, err2)
    _no_port_kernels("pose_landmark")
    emit("pose_landmark", worlds=dict(
        w3d=dict(poses=len(gt3), landmarks=len({j for (_, j, _) in world3[2]}),
                 observations=len(world3[2])),
        city=dict(poses=len(gt5), landmarks=len(lm5_init), observations=len(obs5)),
        w2d=dict(poses=len(gt2), landmarks=len({j for (_, j, _) in world2[2]}),
                 observations=len(world2[2]))),
         worlds_build_s=worlds_s, plateau_rtol={"3d_2d": LANDMARK_RTOL, "city": 1e-6},
         caps={"3d_2d": 60, "city": 30}, cases=rows, checks_3d=checks, tol=LANDMARK_TOL,
         port_kernel_launches=0, device=name, nvidia_smi=smi)


# ---- the inertial stack and the Sim(3) essential graph ----------------------

# benchmarks/run_all.py's GPS-INS stream (:1958-2040): a circle of radius
# 3 m at 0.6 rad/s with a 0.7 rad, 1.3 rad/s yaw sinusoid, 200 Hz IMU,
# keyframes every 0.5 s, constant gyro and accel biases, 5 cm GPS fixes
GPS_INS_KEYFRAMES = 500  # the batch: 8,000 unknowns (H 512 MB in float64)
GPS_INS_SMOOTHER_KEYFRAMES = 200  # the online smoother's stream
GPS_INS_CPU_KEYFRAMES = 41  # run_all.py's size, card against the CPU port
INERTIAL_CPU_TOL = 1e-9
# run_all.py's Sim(3) essential graph (:2171-2269) and the scipy TRF
# optimum it quotes for the float64 polish
SIM3_KEYFRAMES = 200
SIM3_SCIPY_OPTIMUM = 1.58005e-2
SIM3_CHAIN_KEYFRAMES = 2000  # auto picks sparse above 600
SIM3_CPU_TOL = 1e-8


def _gps_ins_stream(n_kf: int, seed: int = 0) -> dict:
    """run_all.py's GPS-INS construction at ``n_kf`` keyframes: the
    preintegrated IMU intervals (biased, noisy) and the GPS fixes, from one
    seed, on the host."""
    from nonlinear_optimizer_for_slam_tpu_torch.ops.imu import GRAVITY, ImuParams, ImuPreintegrator

    rho, omega, yaw_amp, yaw_freq = 3.0, 0.6, 0.7, 1.3
    kf_dt, imu_dt = 0.5, 0.005
    bg = np.array([2e-3, -1e-3, 3e-3])
    ba = np.array([2e-2, -1e-2, 1e-2])
    params = ImuParams(gyro_noise=1e-4, accel_noise=1e-3)
    rng = np.random.default_rng(seed)
    sg = params.gyro_noise / np.sqrt(imu_dt)
    sa = params.accel_noise / np.sqrt(imu_dt)
    pos = lambda t: rho * np.array([np.cos(omega * t), np.sin(omega * t), 0.0])
    vel = lambda t: rho * omega * np.array([-np.sin(omega * t), np.cos(omega * t), 0.0])
    acc = lambda t: -rho * omega**2 * np.array([np.cos(omega * t), np.sin(omega * t), 0.0])

    def rot(t):
        th = omega * t + np.pi / 2 + yaw_amp * np.sin(yaw_freq * t)
        c, s = np.cos(th), np.sin(th)
        return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])

    gyro = lambda t: np.array([0.0, 0.0, omega + yaw_amp * yaw_freq * np.cos(yaw_freq * t)])
    pres, gps = [], []
    for k in range(n_kf - 1):
        pre = ImuPreintegrator(params)
        t = k * kf_dt
        while t < (k + 1) * kf_dt - 1e-9:
            tm = t + 0.5 * imu_dt
            pre.integrate(gyro(tm) + bg + rng.normal(0, sg, 3),
                          rot(tm).T @ (acc(tm) - GRAVITY) + ba + rng.normal(0, sa, 3), imu_dt)
            t += imu_dt
        pres.append(pre)
    for k in range(n_kf):
        gps.append(pos(k * kf_dt) + rng.normal(0, 0.05, 3))
    return dict(pres=pres, gps=gps, pos=pos, vel=vel, rot=rot, kf_dt=kf_dt, bg=bg, ba=ba,
                params=params, gravity=GRAVITY)


def _predict(stream, R, p, v, pre):
    """Dead reckoning of one interval at zero bias."""
    g = stream["gravity"]
    dR, dv, dp = pre.corrected(np.zeros(3), np.zeros(3))
    return R @ dR, p + v * pre.dt + 0.5 * g * pre.dt**2 + R @ dp, v + g * pre.dt + R @ dv


def _gps_ins_problem(stream, n_kf: int, dev, warm_start: bool = False):
    """An ``InertialGraphOptimizer`` (float64) over the stream's first
    ``n_kf`` keyframes: the pose of state 0 fixed at the truth, GPS priors,
    IMU factors, bias walks from ``bias_walk_sqrt_info`` and a weak zero
    bias prior. The states start dead-reckoned from the true first one
    (run_all.py's start), or with ``warm_start`` at a forward filter's
    level: the GPS fixes, the true velocities and attitudes perturbed by
    5 cm/s and 2 degrees (seeded), zero biases. Dead reckoning over
    hundreds of seconds leaves LM's basin."""
    import nonlinear_optimizer_for_slam_tpu_torch as port
    from nonlinear_optimizer_for_slam_tpu_torch.core.pose import np_axis_angle_to_quat, np_quat_to_rotmat
    from nonlinear_optimizer_for_slam_tpu_torch.ops.imu import bias_walk_sqrt_info

    opt = port.InertialGraphOptimizer(device=dev)
    kf_dt = stream["kf_dt"]
    R, p, v = stream["rot"](0.0), stream["pos"](0.0), stream["vel"](0.0)
    opt.add_state(0, port.Pose(R, p), velocity=v)
    rng = np.random.default_rng(5)
    for k, pre in enumerate(stream["pres"][: n_kf - 1]):
        if warm_start:
            t = (k + 1) * kf_dt
            dR = np_quat_to_rotmat(np_axis_angle_to_quat(rng.normal(0, np.deg2rad(2.0), 3)))
            R, p, v = stream["rot"](t) @ dR, stream["gps"][k + 1], stream["vel"](t) + rng.normal(0, 0.05, 3)
        else:
            R, p, v = _predict(stream, R, p, v, pre)
        opt.add_state(k + 1, port.Pose(R, p), velocity=v)
        opt.add_imu_factor(k, k + 1, pre)
        opt.add_bias_walk(k, k + 1, bias_walk_sqrt_info(stream["params"], pre.dt))
    opt.set_state_constant(0)
    for k in range(n_kf):
        opt.add_position_prior(k, stream["gps"][k], 20.0)
    opt.add_bias_prior(0, np.zeros(6), 10.0)
    return opt


def _inertial_states(opt) -> np.ndarray:
    return np.stack([np.concatenate([s[0].translation, s[0].quaternion(), s[1], s[2]])
                     for s in (opt.get_state(k) for k in range(opt.num_states))])


def _gps_ins_batch(dev, name: str, smi: str, stream) -> None:
    """``InertialGraphOptimizer`` in float64 over GPS_INS_KEYFRAMES of the
    stream (the dense 16N normal equations on the card): wall, LM
    iterations, kernels and idle share an iteration from a profiled solve,
    position errors and the recovered biases; at run_all.py's 41 keyframes
    the card's solve against the CPU port's (counts equal, states within
    INERTIAL_CPU_TOL). No port kernel runs."""
    import torch

    from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck

    ck.reset_launches()
    options = _plateau(100, 1e-5)  # run_all.py's plateau options for this row
    n = GPS_INS_KEYFRAMES
    t0 = time.perf_counter()
    _gps_ins_problem(stream, n, dev, warm_start=True).solve(_plateau(2, 1e-5))  # warm-up
    warm_s = time.perf_counter() - t0
    opt = _gps_ins_problem(stream, n, dev, warm_start=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    summary = opt.solve(options)
    wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_eval = int(np.sum(~np.isnan(summary.records.cost)))
    kf_dt = stream["kf_dt"]
    errs = [float(np.linalg.norm(opt.get_pose(k).translation - stream["pos"](k * kf_dt)))
            for k in range(n)]
    _, v_mid, b_mid = opt.get_state(n // 2)
    prof = _profile(lambda: _gps_ins_problem(stream, n, dev, warm_start=True).solve(
        _plateau(3, 1e-5)), warm=False)
    # the card against the CPU port at run_all.py's size
    small = GPS_INS_CPU_KEYFRAMES
    card = _gps_ins_problem(stream, small, dev)
    s_card = card.solve(options)
    cpu = _gps_ins_problem(stream, small, "cpu")
    s_cpu = cpu.solve(options)
    cpu_diff = float(np.abs(_inertial_states(card) - _inertial_states(cpu)).max())
    _no_port_kernels("gps_ins_batch")
    row = dict(
        keyframes=n, unknowns=16 * n, imu_rate_hz=200, warm_up_s=warm_s, wall_ms=wall,
        lm_iterations=int(summary.iterations), lm_evaluations=n_eval,
        ms_per_lm_iteration=wall / n_eval, converged=bool(summary.converged),
        initial_cost=float(summary.records.cost[0]), final_cost=float(summary.final_cost),
        peak_memory_gb=peak, max_position_err_m=max(errs), mean_position_err_m=float(np.mean(errs)),
        gyro_bias=b_mid[:3].tolist(), accel_bias=b_mid[3:].tolist(),
        gyro_bias_true=stream["bg"].tolist(), accel_bias_true=stream["ba"].tolist(),
        velocity_err=float(np.linalg.norm(v_mid - stream["vel"]((n // 2) * kf_dt))),
        profiled_lm_evaluations=3,
        device_kernels_per_lm_iteration=prof["device_kernels"] / 3,
        device_busy_ms=prof["device_busy_ms"], device_idle_share=prof["device_idle_share"],
        profiled_wall_ms=prof["wall_ms"], top_device=prof["top_device"][:5],
    )
    card_vs_cpu = dict(keyframes=small, lm_iterations=[int(s_card.iterations), int(s_cpu.iterations)],
                       state_max_diff=cpu_diff, tol=INERTIAL_CPU_TOL)
    if not (np.isfinite(row["final_cost"]) and row["final_cost"] < row["initial_cost"]
            and max(errs) < 0.5):
        raise AssertionError(f"gps_ins_batch: {row}")
    if int(s_card.iterations) != int(s_cpu.iterations) or cpu_diff > INERTIAL_CPU_TOL:
        raise AssertionError(f"gps_ins_batch: card vs CPU {card_vs_cpu}")
    emit("gps_ins_batch", batch=row, card_vs_cpu=card_vs_cpu, dtype="float64",
         port_kernel_launches=0, device=name, nvidia_smi=smi)


def _inertial_smoother(dev, name: str, smi: str, stream) -> None:
    """``FixedLagInertialSmoother(lag=10)`` over the stream's first
    GPS_INS_SMOOTHER_KEYFRAMES, blocking and ``update_async`` with
    ``marginalize_every=4`` (run_all.py:2069-2119's two modes): ms a
    keyframe, LM iterations an update, position errors. Each keyframe is
    predicted from the last smoothed state in the blocking run; the
    streaming run takes the same predictions (a read would flush). No port
    kernel runs."""
    import torch

    import nonlinear_optimizer_for_slam_tpu_torch as port
    from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck
    from nonlinear_optimizer_for_slam_tpu_torch.ops.imu import bias_walk_sqrt_info

    ck.reset_launches()
    kf_dt = stream["kf_dt"]
    rows = {}
    predictions = []  # the blocking run's (R, p, v) of each new keyframe
    for mode, me in (("blocking", 1), ("async_every4", 4)):
        sm = port.FixedLagInertialSmoother(lag=10, marginalize_every=me, device=dev)
        R, p, v = stream["rot"](0.0), stream["pos"](0.0), stream["vel"](0.0)
        sm.add_state(0, port.Pose(R, p), velocity=v)
        sm.add_position_prior(0, stream["gps"][0], 20.0)
        sm.add_bias_prior(0, np.zeros(6), 10.0)
        sm.update()
        per, iters = [], []
        t_all = time.perf_counter()
        for k, pre in enumerate(stream["pres"][: GPS_INS_SMOOTHER_KEYFRAMES - 1]):
            if me == 1:
                # predicted from the smoothed state of the last update
                R, p, v = _predict(stream, R, p, v, pre)
                predictions.append((R, p, v))
            else:
                # the same predictions: a read would flush every frame
                R, p, v = predictions[k]
            t0 = time.perf_counter()
            sm.add_state(k + 1, port.Pose(R, p), velocity=v)
            sm.add_imu_factor(k, k + 1, pre)
            sm.add_bias_walk(k, k + 1, bias_walk_sqrt_info(stream["params"], pre.dt))
            sm.add_position_prior(k + 1, stream["gps"][k + 1], 20.0)
            if me == 1:
                sm.update()
                torch.cuda.synchronize()
                per.append((time.perf_counter() - t0) * 1e3)
                iters.append(int(sm.last_summary.iterations))
                pose_k, v, _ = sm.get_state(k + 1)
                R, p = pose_k.rotation, pose_k.translation
            else:
                sm.update_async()
                torch.cuda.synchronize()
                per.append((time.perf_counter() - t0) * 1e3)
        sm.flush()
        total_s = time.perf_counter() - t_all
        errs = [float(np.linalg.norm(sm.get_pose(k).translation - stream["pos"](k * kf_dt)))
                for k in sm.window]
        rows[mode] = dict(
            marginalize_every=me, keyframes=GPS_INS_SMOOTHER_KEYFRAMES, lag=10,
            ms_per_keyframe_median=statistics.median(per[15:]),
            ms_per_keyframe_mean=float(np.mean(per)), total_s=total_s,
            lm_iterations_per_update=float(np.mean(iters)) if iters else None,
            window=sm.window, window_max_position_err_m=max(errs),
        )
        if not all(np.isfinite(e) for e in errs):
            raise AssertionError(f"inertial_smoother {mode}: {rows[mode]}")
    _no_port_kernels("inertial_smoother")
    if rows["blocking"]["window_max_position_err_m"] > 0.5:
        raise AssertionError(f"inertial_smoother: {rows}")
    emit("inertial_smoother", modes=rows, dtype="float64", port_kernel_launches=0,
         device=name, nvidia_smi=smi)


def _sim3_between(a, b):
    from nonlinear_optimizer_for_slam_tpu_torch.core.lie import np_quat_multiply
    from nonlinear_optimizer_for_slam_tpu_torch.core.pose import np_quat_to_rotmat

    Ra = np_quat_to_rotmat(a[3:7] / np.linalg.norm(a[3:7]))
    dt_ = Ra.T @ (b[:3] - a[:3]) / np.exp(a[7])
    dq = np_quat_multiply(a[3:7] * np.array([1.0, -1, -1, -1]), b[3:7])
    return np.concatenate([dt_, dq / np.linalg.norm(dq), [b[7] - a[7]]])


def _sim3_graph(P: int, drift: float, radius: float, loops, seed: int):
    """run_all.py's Sim(3) construction: keyframes on a circle with the
    log-scale -k ln(drift), noisy similarity odometry (5 mm, 2 mrad, 2e-3 in
    log-scale), the naive rigid dead reckoning as the start, and loop
    closures ``loops`` (pairs) with the same noise. Returns (registry
    arguments, target states)."""
    from nonlinear_optimizer_for_slam_tpu_torch.core.lie import np_quat_multiply
    from nonlinear_optimizer_for_slam_tpu_torch.core.pose import np_quat_to_rotmat

    target = []
    for k in range(P):
        q = np.array([np.cos(np.pi * k / P), 0, 0, np.sin(np.pi * k / P)])
        target.append(np.concatenate(
            [[radius * np.cos(2 * np.pi * k / P), radius * np.sin(2 * np.pi * k / P), 0.0], q,
             [-k * np.log(drift)]]))
    rng = np.random.default_rng(seed)

    def noisy(m):
        dq = np.concatenate([[1.0], rng.normal(0, 2e-3, 3)])
        q = np_quat_multiply(m[3:7], dq / np.linalg.norm(dq))
        return np.concatenate([m[:3] + rng.normal(0, 5e-3, 3), q, [m[7] + rng.normal(0, 2e-3)]])

    meas = [noisy(_sim3_between(target[k], target[k + 1])) for k in range(P - 1)]
    closures = [(a, b, noisy(_sim3_between(target[a], target[b]))) for a, b in loops]
    rot = lambda x: np_quat_to_rotmat(x[3:7] / np.linalg.norm(x[3:7]))
    init = [target[0].copy()]
    for m in meas:
        prev = init[-1]
        init.append(np.concatenate(
            [prev[:3] + rot(prev) @ m[:3], np_quat_multiply(prev[3:7], m[3:7]), [0.0]]))
    return dict(init=init, meas=meas, closures=closures, rot=rot), target


def _sim3_optimizer(graph, dev, **kw):
    import nonlinear_optimizer_for_slam_tpu_torch as port

    rot = graph["rot"]
    opt = port.Sim3GraphOptimizer(device=dev, **kw)
    for k, x in enumerate(graph["init"]):
        opt.set_pose(k, port.Pose(rot(x), x[:3]), scale=1.0)
    opt.set_pose_constant(0)
    for k, m in enumerate(graph["meas"]):
        opt.set_constraint(k, k + 1, port.Pose(rot(m), m[:3]),
                           relative_scale=float(np.exp(m[7])), sqrt_info=(10.0, 20.0, 1.0))
    for a, b, m in graph["closures"]:
        opt.set_constraint(a, b, port.Pose(rot(m), m[:3]),
                           relative_scale=float(np.exp(m[7])), sqrt_info=(50.0, 100.0, 50.0))
    return opt


def _sim3_vs_cpu(graph, card_opt, card_summary, **kw) -> dict:
    """The same initialize() and default solve on the CPU port: LM counts
    equal and every pose and log-scale within SIM3_CPU_TOL, or a raise."""
    cpu = _sim3_optimizer(graph, "cpu", **kw)
    cpu.initialize()
    s_cpu = cpu.solve()
    states = lambda o: np.stack([o._poses[k] for k in sorted(o._poses)])
    diff = float(np.abs(states(card_opt) - states(cpu)).max())
    out = dict(lm_iterations=[int(card_summary.iterations), int(s_cpu.iterations)],
               state_max_diff=diff, tol=SIM3_CPU_TOL)
    if int(card_summary.iterations) != int(s_cpu.iterations) or diff > SIM3_CPU_TOL:
        raise AssertionError(f"sim3: card vs CPU port {out}")
    return out


def _sim3(dev, name: str, smi: str) -> None:
    """The Sim(3) essential graph: run_all.py's 200 keyframes with 2 %/edge
    (52x) monocular scale drift and one loop, through ``initialize()`` and
    the dense solve with the default schedule, in float32 with
    ``polish="auto"`` (the float64 polish on the card) and in float64 (final
    cost against the scipy optimum SIM3_SCIPY_OPTIMUM, rtol 1e-3; float64
    against the CPU port: counts equal, states within SIM3_CPU_TOL); then a
    SIM3_CHAIN_KEYFRAMES drifting chain (0.2 %/edge, 54x) on a 40 m circle
    with 40 loop closures (the closing one, 20 chords a third of the way
    round, one back half a stride every 100 keyframes) through
    ``solver="auto"`` (sparse), float64, against the CPU port likewise. No
    port kernel runs."""
    import torch

    from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck

    ck.reset_launches()
    graph, target = _sim3_graph(SIM3_KEYFRAMES, 1.02, 6.0, [(SIM3_KEYFRAMES - 1, 0)], seed=77)
    rows = {}
    for label, dtype in (("float32_polish_auto", torch.float32), ("float64", torch.float64)):
        def solve():
            opt = _sim3_optimizer(graph, dev, dtype=dtype)
            t0 = time.perf_counter()
            opt.initialize()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            summary = opt.solve()
            return opt, summary, (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

        solve()  # warm-up
        opt, summary, init_ms, solve_ms = solve()
        err = max(float(np.linalg.norm(opt.get_pose(k).translation - target[k][:3]))
                  for k in range(SIM3_KEYFRAMES))
        rows[label] = dict(
            initialize_ms=init_ms, solve_ms=solve_ms, lm_iterations=int(summary.iterations),
            converged=bool(summary.converged), final_cost=float(summary.final_cost),
            cost_vs_scipy_rel=float(summary.final_cost) / SIM3_SCIPY_OPTIMUM - 1.0,
            max_position_err_m=err, solver=opt.last_solver_choice,
        )
        if opt.last_solver_choice != "dense" or abs(rows[label]["cost_vs_scipy_rel"]) > 1e-3:
            raise AssertionError(f"sim3 {label}: {rows[label]}")
    rows["float64"]["vs_cpu_port"] = _sim3_vs_cpu(graph, opt, summary)
    P = SIM3_CHAIN_KEYFRAMES
    loops = ([(P - 1, 0)]
             + [(a, a + P // 3) for a in np.linspace(3, P - P // 3 - 3, 20).astype(int)]
             + [(a, a - 50) for a in range(100, P, 100)])
    chain, chain_target = _sim3_graph(P, 1.002, 40.0, loops, seed=78)

    def chain_solve():
        opt = _sim3_optimizer(chain, dev, solver="auto")
        t0 = time.perf_counter()
        opt.initialize()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        summary = opt.solve()
        return opt, summary, (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

    chain_solve()  # warm-up (the symbolic plan is per optimizer)
    opt, summary, init_ms, solve_ms = chain_solve()
    n_eval = int(np.sum(~np.isnan(summary.records.cost)))
    rec = summary.records.cost
    chain_row = dict(
        keyframes=P, edges=P - 1 + len(loops), loops=len(loops), drift_per_edge=1.002,
        solver=opt.last_solver_choice, initialize_ms=init_ms, solve_ms=solve_ms,
        lm_iterations=int(summary.iterations), converged=bool(summary.converged),
        first_cost=float(rec[0]), final_cost=float(summary.final_cost),
        ms_per_lm_iteration=solve_ms / n_eval,
        max_position_err_m=max(float(np.linalg.norm(opt.get_pose(k).translation
                                                    - chain_target[k][:3])) for k in range(P)),
    )
    if opt.last_solver_choice != "sparse" or not chain_row["final_cost"] <= chain_row["first_cost"]:
        raise AssertionError(f"sim3 chain: {chain_row}")
    chain_row["vs_cpu_port"] = _sim3_vs_cpu(chain, opt, summary, solver="auto")
    _no_port_kernels("sim3")
    emit("sim3", essential_graph=dict(keyframes=SIM3_KEYFRAMES, drift_per_edge=1.02,
                                      scipy_optimum=SIM3_SCIPY_OPTIMUM, cases=rows),
         chain=chain_row, port_kernel_launches=0, device=name, nvidia_smi=smi)


def _evaluations(summaries) -> int:
    """LM evaluations of the inner solves: their recorded costs."""
    import torch

    return sum(int((~torch.isnan(s.records.cost)).sum().item()) for s in summaries)


def _error_scale(all_terms) -> "torch.Tensor":
    """(B, outputs): the scale of each output's float32 rounding error.

    An output is a sum over factors of terms; its rounding error scales
    with the magnitudes of the products each term adds, which the sum of
    |terms| bounds unless those products cancel inside a term. They do in
    H entries that vanish by symmetry (reproj's H(2, 5) at the identity is
    exactly 0: every term is x y / z^3 - y x / z^3), where kernel and
    plain version then differ by rounding only, against a sum of |terms|
    that is rounding too. An off-diagonal entry sums w J_a . J_b with
    w >= 0, so Cauchy-Schwarz bounds its products by sqrt(H_aa H_bb), the
    sums of its diagonals' terms (which are >= 0): that is its scale where
    larger than its own sum of |terms|."""
    import torch

    scale = all_terms.abs().sum(dim=-1)
    n_out = all_terms.shape[1]
    dim = next(d for d in (6, 3) if d * (d + 1) // 2 + d + 1 == n_out)
    upper = [(a, b) for a in range(dim) for b in range(a, dim)]
    diag = {a: k for k, (a, b) in enumerate(upper) if a == b}
    for k, (a, b) in enumerate(upper):
        if a != b:
            scale[:, k] = torch.maximum(
                scale[:, k], torch.sqrt(scale[:, diag[a]] * scale[:, diag[b]])
            )
    return scale


def _ptxas_summary(log: str) -> list:
    """'function: registers, spills' for each kernel in an ``nvcc -Xptxas -v``
    log."""
    out, fn, spills = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill stores" in line and fn:
            spills = line.strip()
        elif "Used" in line and "registers" in line and fn:
            out.append(f"{fn}: {line.split(':', 1)[1].strip()}; {spills}")
            fn = None
    return out


def _check_traced_launches(phase: str, prof: dict, steps: int) -> None:
    """A registrar run's port kernels in the trace (``_profile``) against
    its ``ck.LAUNCHES`` count: one launch a step, each in the trace, so a
    count that a graph replay adds is held to the kernels it ran."""
    traced, counted = sum(prof["port_kernels"].values()), sum(prof["port_launches"].values())
    if not traced == counted == steps:
        raise AssertionError(f"{phase}: port kernels {prof['port_kernels']} in the trace, "
                             f"ck.LAUNCHES {prof['port_launches']} in the profiled call, "
                             f"{steps} steps, want one launch a step")


def _walls_ms(fn, runs: int) -> list:
    """Host wall times of ``runs`` calls of ``fn``, each ending in a
    synchronise, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def _wall_ms(fn, runs: int) -> float:
    return statistics.median(_walls_ms(fn, runs))


def _profile(fn, warm: bool = True) -> dict:
    """Where the device time of one call of ``fn`` goes, by kernel name
    (torch.profiler, CUPTI): device busy, idle share, top kernels, and the
    port's launch counts (``ck.LAUNCHES``) of the profiled call beside the
    trace's. A warm-up call comes first unless ``warm`` is False."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck

    if warm:
        fn()
    torch.cuda.synchronize()
    before = dict(ck.LAUNCHES)  # a difference: the caller's counts run on
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0
    launches = {k: v - before[k] for k, v in ck.LAUNCHES.items() if v != before[k]}
    events = prof.key_averages()
    rows = sorted(  # device-side events only: a CPU op's device time repeats its kernels',
        # and a span's mirror on the device's timeline (the port's nls.* spans) is no work
        ((ev.self_device_time_total, ev.key, ev.count) for ev in events
         if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
         and not getattr(ev, "is_user_annotation", False)),
        reverse=True,
    )
    host = sorted(
        ((ev.self_cpu_time_total, ev.key, ev.count) for ev in events
         if ev.device_type == DeviceType.CPU and ev.self_cpu_time_total > 0),
        reverse=True,
    )
    device_ms = sum(r[0] for r in rows) / 1000.0
    # the port's own kernels by name (which finish) and template arguments
    # (which factor), argument list cut; two trace keys that share a name
    # (the same kernel under two keys) add up, and the raw keys go in the
    # line, so that a count short of ck.LAUNCHES shows which keys it had
    port_kernels, port_kernel_keys = {}, {}
    for _, k, c in rows:
        if "nls::" in k:
            prefix = k[: k.find(">(") + 1]
            port_kernels[prefix] = port_kernels.get(prefix, 0) + c
            port_kernel_keys[k] = c
    return dict(
        wall_ms=wall_ms, device_busy_ms=device_ms,
        device_idle_share=(1.0 - device_ms / wall_ms) if device_ms else None,
        device_kernels=sum(r[2] for r in rows), port_kernels=port_kernels,
        port_kernel_keys=port_kernel_keys, port_launches=launches,
        top_device=[{"name": k[:80], "ms": us / 1000.0, "count": c} for us, k, c in rows[:10]],
        top_host=[{"name": k[:80], "ms": us / 1000.0, "count": c} for us, k, c in host[:10]],
    )


def _time_ms(fn, iters: int):
    """(device ms per call with the calls queued back to back, ms per call
    as the host issues them), each the median of 5 runs of ``iters`` calls
    timed with CUDA events. For the first, a sleep kernel holds the stream
    while the host queues the calls, so host launch cost is hidden."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    # sleep-kernel cycles per ms on this card
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(10_000_000)
    e.record()
    torch.cuda.synchronize()
    cycles_per_ms = 10_000_000 / s.elapsed_time(e)

    host, queued = [], []
    for _ in range(5):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        host.append(s.elapsed_time(e) / iters)

        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(cycles_per_ms * (2.0 * enqueue_ms + 5.0)))
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
        queued.append(s.elapsed_time(e) / iters)
    return statistics.median(queued), statistics.median(host)


if __name__ == "__main__":
    sys.exit(main())
