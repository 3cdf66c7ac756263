"""The port's generic Problem / PoseOptimizer (``solvers/problem.py``) and
the rest of ``core/lie.py`` against the JAX package's, mirroring
tests/test_problem.py.

Each problem is built once for JAX and handed to the port through
``interop.from_reference(problem=...)``; both solve it in float64 on the
CPU. Tolerances: the iteration counts are equal; ``records.cost`` and
``records.lam`` agree iteration by iteration within rtol 1e-9 (costs also
within 1e-12 of the first iteration's cost: once a solve converges its
costs are sums of squares at the rounding floor, some 1e-18, where two
correct orders of summation differ relatively by far more); the solved
poses agree within 1e-8, and each keeps the JAX test's own bounds. The
hand-eye functor is a user-defined ``CostFunction`` on both sides, its
Jacobians by ``jax.jacfwd`` and by ``torch.func.jacfwd``; the port's
closed-form prior Jacobians agree with ``jax.jacfwd`` of JAX's functors
and with the port's own ``jacfwd`` default within 1e-12 of their
largest entry. ``rotmat_to_quat``,
``skew`` and ``se3_apply`` agree with JAX's within rtol 1e-12, rotations
near pi included.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinear_optimizer_for_slam_tpu as nls
from nonlinear_optimizer_for_slam_tpu.core import ExponentialLoss, HuberLoss
from nonlinear_optimizer_for_slam_tpu.core import lie as jlie
from nonlinear_optimizer_for_slam_tpu.solvers import problem as jp
import nonlinear_optimizer_for_slam_tpu_torch as port
from nonlinear_optimizer_for_slam_tpu_torch import interop
from nonlinear_optimizer_for_slam_tpu_torch.core import lie as tlie
from nonlinear_optimizer_for_slam_tpu_torch.solvers import problem as tp

RECORD_RTOL = 1e-9
POSE_ATOL = 1e-8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tests run many tiny ops, which more
    threads only slow down when test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def true_pose():
    return nls.Pose.from_axis_angle(0.07, [0.2, -0.3, 1.0], [0.15, -0.1, 0.25])


_ARRAYS = {
    "MahalanobisDistanceCostFunctor": ("points", "means", "sqrt_infos", "_mask"),
    "PointToPlaneCostFunctor": ("points", "means", "normals", "_mask"),
    "TranslationDeltaCostFunctor": ("target", "sqrt_info"),
    "RotationDeltaCostFunctor": ("target", "sqrt_info"),
}
_ARGS = {
    "_mask": "mask",
    "target": {"TranslationDeltaCostFunctor": "target_translation",
               "RotationDeltaCostFunctor": "target_rotation"},
}


def _spec(problem):
    """The interop ``problem`` list of a JAX Problem."""
    out = []
    for blk in problem.residual_blocks:
        f = blk.cost_function
        name = type(f).__name__
        arrays = {}
        for attr in _ARRAYS[name]:
            arg = _ARGS.get(attr, attr)
            arg = arg[name] if isinstance(arg, dict) else arg
            value = getattr(f, attr)
            arrays[arg] = None if value is None else np.asarray(value)
        loss = None if blk.loss is None else (
            type(blk.loss).__name__,
            {k: float(v) for k, v in dataclasses.asdict(blk.loss).items()},
        )
        out.append((name, arrays, loss))
    return out


def _port_pose(pose):
    return port.Pose(pose.rotation, pose.translation)


def _options(jopts):
    return tp.GenericOptions(**dataclasses.asdict(jopts))


def _solve_both(jproblem, jopts=None, start=None, tproblem=None):
    """Solve with both packages; hold counts, records and poses to each
    other. Returns (JAX pose, JAX summary, port pose, port summary)."""
    jopts = jopts or jp.GenericOptions()
    start = start or nls.Pose.identity()
    if tproblem is None:
        tproblem = interop.from_reference(problem=_spec(jproblem), device="cpu").problem
    jpose, jsum = jp.PoseOptimizer().solve(jproblem, jopts, start)
    tpose, tsum = tp.PoseOptimizer(device="cpu").solve(tproblem, _options(jopts), _port_pose(start))
    assert int(tsum.iterations) == int(jsum.iterations)
    assert bool(tsum.converged) == bool(jsum.converged)
    ran = int(np.sum(~np.isnan(np.asarray(jsum.records.cost))))
    assert int(torch.sum(~torch.isnan(tsum.records.cost))) == ran
    jcost = np.asarray(jsum.records.cost)[:ran]
    np.testing.assert_allclose(
        tsum.records.cost[:ran].numpy(), jcost, rtol=RECORD_RTOL, atol=1e-12 * jcost[0]
    )
    np.testing.assert_allclose(
        tsum.records.lam[:ran].numpy(), np.asarray(jsum.records.lam)[:ran], rtol=RECORD_RTOL
    )
    np.testing.assert_allclose(float(tsum.final_lambda), float(jsum.final_lambda), rtol=RECORD_RTOL)
    np.testing.assert_allclose(tpose.translation, jpose.translation, atol=POSE_ATOL)
    np.testing.assert_allclose(tpose.rotation, jpose.rotation, atol=POSE_ATOL)
    return jpose, jsum, tpose, tsum


def test_mahalanobis_block_recovers_pose(rng, true_pose):
    n = 400
    pts = rng.uniform(-2, 2, size=(n, 3))
    problem = jp.Problem()
    problem.add_residual_block(
        jp.MahalanobisDistanceCostFunctor(pts, true_pose.apply(pts), np.tile(np.eye(3), (n, 1, 1)))
    )
    _, _, pose, summary = _solve_both(problem)
    np.testing.assert_allclose(pose.translation, true_pose.translation, atol=1e-6)
    np.testing.assert_allclose(pose.rotation, true_pose.rotation, atol=1e-6)
    assert bool(summary.converged)


def test_mixed_blocks_with_priors(rng, true_pose):
    n = 200
    pts = rng.uniform(-2, 2, size=(n, 3))
    means = true_pose.apply(pts)
    normals = rng.normal(size=(n, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    problem = jp.Problem()
    problem.add_residual_block(
        jp.MahalanobisDistanceCostFunctor(pts, means, np.tile(np.eye(3), (n, 1, 1))),
        ExponentialLoss(),
    )
    problem.add_residual_block(jp.PointToPlaneCostFunctor(pts, means, normals), HuberLoss(2.0))
    problem.add_residual_block(
        jp.TranslationDeltaCostFunctor(true_pose.translation, 10.0 * np.eye(3))
    )
    problem.add_residual_block(jp.RotationDeltaCostFunctor(true_pose.rotation, 10.0 * np.eye(3)))
    _, _, pose, _ = _solve_both(problem)
    np.testing.assert_allclose(pose.translation, true_pose.translation, atol=1e-5)
    np.testing.assert_allclose(pose.rotation, true_pose.rotation, atol=1e-5)


def test_priors_pull_solution():
    """With ONLY priors, the optimum is the prior pose."""
    target = nls.Pose.from_axis_angle(0.2, [0, 1.0, 0], [1.0, 2.0, -0.5])
    problem = jp.Problem()
    problem.add_residual_block(jp.TranslationDeltaCostFunctor(target.translation))
    problem.add_residual_block(jp.RotationDeltaCostFunctor(target.rotation))
    _, _, pose, _ = _solve_both(problem)
    np.testing.assert_allclose(pose.translation, target.translation, atol=1e-6)
    np.testing.assert_allclose(pose.rotation, target.rotation, atol=1e-6)


def test_loss_actually_applied(rng, true_pose):
    """The reference's ResidualBlock skips a configured loss
    (cost_function.h:96-104); the port applies it: 10 % gross outliers
    shift the no-loss optimum, a robust loss holds it near the truth."""
    n = 300
    pts = rng.uniform(-2, 2, size=(n, 3))
    means = true_pose.apply(pts)
    means[: n // 10] += 5.0

    def solve(loss):
        problem = jp.Problem()
        problem.add_residual_block(
            jp.MahalanobisDistanceCostFunctor(pts, means, np.tile(np.eye(3), (n, 1, 1))), loss
        )
        _, _, pose, _ = _solve_both(problem)
        return np.linalg.norm(pose.translation - true_pose.translation)

    err_plain = solve(None)
    err_robust = solve(HuberLoss(threshold=0.5))
    assert err_robust < 0.3 * err_plain, (err_robust, err_plain)


def test_function_tolerance_is_read(rng, true_pose):
    """The generic policy breaks on |cost - prev| < function_tolerance."""
    n = 100
    pts = rng.uniform(-2, 2, size=(n, 3))
    means = true_pose.apply(pts) + 0.01 * rng.normal(size=(n, 3))
    problem = jp.Problem()
    problem.add_residual_block(
        jp.MahalanobisDistanceCostFunctor(pts, means, np.tile(np.eye(3), (n, 1, 1)))
    )
    loose = jp.GenericOptions(
        function_tolerance=1e30, parameter_tolerance=0.0, gradient_tolerance=0.0
    )
    _, _, _, summary = _solve_both(problem, loose)
    assert int(summary.iterations) <= 1
    # reported_cost lags: the previous cost, as in JAX
    assert float(summary.reported_cost) == float(summary.records.cost[0])


def test_empty_problem_raises():
    with pytest.raises(ValueError, match="no residual blocks"):
        tp.PoseOptimizer(device="cpu").solve(tp.Problem(), tp.GenericOptions(), port.Pose.identity())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.PoseOptimizer()


def test_rank_deficient_problem_solves_constrained_part():
    """Priors on the translation alone (a zero rotation block in H) average
    to [2, 0, 0], rotation identity: the 1e-10 (max|diag H| + 1) floor."""
    problem = jp.Problem()
    problem.add_residual_block(jp.TranslationDeltaCostFunctor(np.array([1.0, 0, 0])))
    problem.add_residual_block(jp.TranslationDeltaCostFunctor(np.array([3.0, 0, 0])))
    _, _, pose, _ = _solve_both(problem)
    np.testing.assert_allclose(pose.translation, [2.0, 0, 0], atol=1e-8)
    np.testing.assert_allclose(pose.rotation, np.eye(3), atol=1e-10)


def _exp_so3(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


class _JaxHandEye(jp.CostFunction):
    def __init__(self, R_a, t_a, R_b, t_b):
        self.R_a, self.t_a = jnp.asarray(R_a), jnp.asarray(t_a)
        self.R_b, self.t_b = jnp.asarray(R_b), jnp.asarray(t_b)

    def residuals(self, R, t):
        rot = (self.R_a @ R - R @ self.R_b).reshape(len(self.t_a), 9)
        trans = (
            jnp.einsum("nij,j->ni", self.R_a, t) + self.t_a
            - jnp.einsum("ij,nj->ni", R, self.t_b) - t
        )
        return jnp.concatenate([rot, trans], axis=1)


class _PortHandEye(tp.CostFunction):
    def __init__(self, R_a, t_a, R_b, t_b):
        self.R_a, self.t_a = torch.as_tensor(R_a), torch.as_tensor(t_a)
        self.R_b, self.t_b = torch.as_tensor(R_b), torch.as_tensor(t_b)

    def residuals(self, R, t):
        rot = (self.R_a @ R - R @ self.R_b).reshape(len(self.t_a), 9)
        trans = (
            torch.einsum("nij,j->ni", self.R_a, t) + self.t_a
            - torch.einsum("ij,nj->ni", R, self.t_b) - t
        )
        return torch.cat([rot, trans], dim=1)


def test_hand_eye_calibration_with_custom_functor():
    """AX = XB extrinsic calibration through a USER-DEFINED CostFunction
    whose Jacobians come from the base class (jacfwd on both sides)."""
    rng = np.random.default_rng(0)
    X = nls.Pose(_exp_so3([0.2, -0.4, 0.7]), np.array([0.12, -0.05, 0.30]))
    N = 30
    R_a = np.stack([_exp_so3(rng.uniform(-1.2, 1.2, 3)) for _ in range(N)])
    t_a = rng.uniform(-0.5, 0.5, (N, 3))
    Xi = X.inverse()
    B = [Xi * nls.Pose(R_a[k], t_a[k]) * X for k in range(N)]
    R_b = np.stack([b.rotation for b in B])
    t_b = np.stack([b.translation for b in B])

    jproblem = jp.Problem()
    jproblem.add_residual_block(_JaxHandEye(R_a, t_a, R_b, t_b), HuberLoss(0.05))
    tproblem = tp.Problem()
    tproblem.add_residual_block(_PortHandEye(R_a, t_a, R_b, t_b), port.HuberLoss(0.05))
    # the jacfwd Jacobians at a pose away from the solution
    R0 = torch.as_tensor(_exp_so3([0.1, 0.2, -0.3]))
    t0 = torch.tensor([0.3, -0.2, 0.1], dtype=torch.float64)
    r_t, J_t = tproblem.residual_blocks[0].cost_function.residuals_and_jacobians(R0, t0)
    r_j, J_j = jproblem.residual_blocks[0].cost_function.residuals_and_jacobians(
        jnp.asarray(R0.numpy()), jnp.asarray(t0.numpy())
    )
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(J_t.numpy(), np.asarray(J_j), rtol=1e-12, atol=1e-14)

    _, _, est, _ = _solve_both(
        jproblem, jp.GenericOptions(max_iterations=100), tproblem=tproblem
    )
    np.testing.assert_allclose(est.translation, X.translation, atol=1e-8)
    np.testing.assert_allclose(est.rotation, X.rotation, atol=1e-8)


def test_prior_jacobians_match_jacfwd(rng):
    """The translation and rotation priors' closed-form Jacobians against
    jax.jacfwd of JAX's functors and the port's jacfwd default, at random
    poses, near the prior and near a half turn from it."""
    for k in range(6):
        target = nls.Pose.from_axis_angle(
            np.pi - 1e-4 if k % 3 == 0 else rng.uniform(0, 3), rng.normal(size=3), rng.normal(size=3)
        )
        S = rng.normal(size=(3, 3))
        near = target.rotation @ nls.Pose.from_axis_angle(1e-4, rng.normal(size=3)).rotation
        q = rng.normal(size=4)
        R = near if k % 2 else nls.Pose.from_quat_trans(q / np.linalg.norm(q), np.zeros(3)).rotation
        t = rng.normal(size=3)
        pairs = (
            (jp.TranslationDeltaCostFunctor(target.translation, S),
             tp.TranslationDeltaCostFunctor(target.translation, S, device="cpu")),
            (jp.RotationDeltaCostFunctor(target.rotation, S),
             tp.RotationDeltaCostFunctor(target.rotation, S, device="cpu")),
        )
        for jf, tf in pairs:
            r, J = tf.residuals_and_jacobians(torch.as_tensor(R), torch.as_tensor(t))
            r_j, J_j = jf.residuals_and_jacobians(jnp.asarray(R), jnp.asarray(t))
            _, J_f = tp.CostFunction.residuals_and_jacobians(tf, torch.as_tensor(R), torch.as_tensor(t))
            scale = np.abs(np.asarray(J_j)).max()
            np.testing.assert_allclose(r.numpy(), np.asarray(r_j), rtol=1e-12, atol=1e-15)
            np.testing.assert_allclose(J.numpy(), np.asarray(J_j), rtol=0, atol=1e-12 * scale)
            np.testing.assert_allclose(J.numpy(), J_f.numpy(), rtol=0, atol=1e-12 * scale)


# ---- core/lie.py: rotmat_to_quat, skew, se3_apply --------------------------


def _rotations_near_pi(rng):
    """Random rotations, and rotations by pi and pi - 1e-9 about random and
    coordinate axes (where the trace formula fails and each of the four
    candidates wins somewhere)."""
    out = []
    for _ in range(16):
        q = rng.normal(size=4)
        out.append(nls.Pose.from_quat_trans(q / np.linalg.norm(q), np.zeros(3)).rotation)
    axes = [rng.normal(size=3) for _ in range(4)] + list(np.eye(3))
    for axis in axes:
        for angle in (np.pi, np.pi - 1e-9, 1e-12, 0.0):
            out.append(_exp_so3(angle * axis / np.linalg.norm(axis)) if angle else np.eye(3))
    return np.stack(out)


def test_lie_rotmat_to_quat_skew_se3_apply(rng):
    R = _rotations_near_pi(rng)
    q_t = tlie.rotmat_to_quat(torch.as_tensor(R)).numpy()
    q_j = np.asarray(jlie.rotmat_to_quat(jnp.asarray(R)))
    np.testing.assert_allclose(q_t, q_j, rtol=1e-12, atol=1e-15)
    # a unit quaternion of the same rotation
    np.testing.assert_allclose(tlie.quat_to_rotmat(torch.as_tensor(q_t)).numpy(), R, atol=1e-12)
    v = rng.normal(size=(5, 3))
    np.testing.assert_array_equal(
        tlie.skew(torch.as_tensor(v)).numpy(), np.asarray(jlie.skew(jnp.asarray(v)))
    )
    pts, t = rng.normal(size=(7, 3)), rng.normal(size=3)
    np.testing.assert_allclose(
        tlie.se3_apply(torch.as_tensor(R[0]), torch.as_tensor(t), torch.as_tensor(pts)).numpy(),
        np.asarray(jlie.se3_apply(jnp.asarray(R[0]), jnp.asarray(t), jnp.asarray(pts))),
        rtol=1e-12,
    )
