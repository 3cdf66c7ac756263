"""The port's sharded paths (``parallel/``, ``mesh=``) on gloo, in CPU
processes, mirroring tests/test_sharded.py and tests/test_fused_sharded.py.

Three worlds, of 1, 2 and 4 ranks, are spawned at once (one process a
rank, ``init_method="file://..."`` under the test's temporary directory,
no TCP port). Every rank makes the same calls with the full data, made
from seeds with numpy, and writes what it got to an ``.npz``; this process
holds those results to the unsharded port, to JAX's sharded solve on the
8-device virtual mesh of ``conftest.py``, and the ranks of a world to each
other. The paths run the kernels' plain versions here; the kernels are
held on the card by ``chip_smoke.py``'s ``sharded`` phase.

Tolerances (the JAX tests'): ``sharded_quadratic`` and ``shard_solve``
against the local evaluation rtol 1e-12; full solves sharded against unsharded with equal
counts, poses within 1e-10 and final costs within rtol 1e-10 in float64;
``_pad(5) == 4 x world``; CG on the 80-pose fixture with equal counts, cost
rtol 1e-9, poses 1e-7, switches 1e-8; the registrar with equal outer
counts, poses within 1e-4 in float32 and 1e-9 in float64 (6-DoF, planar
and point-to-plane). Within a world
every rank's results are bitwise equal (the fixed-order sum), and a world
of one is bitwise the unsharded solve. The multifrontal factor over a mesh
is bitwise the unsharded factor (each front is factored alone, then
copied), so the sparse pose-graph solve is too.
"""

import os
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import nonlinear_optimizer_for_slam_tpu_torch as port
from nonlinear_optimizer_for_slam_tpu_torch import parallel
from nonlinear_optimizer_for_slam_tpu_torch.ops import mahalanobis, point_to_plane, reprojection
from nonlinear_optimizer_for_slam_tpu_torch.pipelines import ndt
from nonlinear_optimizer_for_slam_tpu_torch.solvers import multifrontal as tmf
from nonlinear_optimizer_for_slam_tpu_torch.solvers import pose_graph as tpg
from nonlinear_optimizer_for_slam_tpu_torch.utils import testing

WORLDS = (1, 2, 4)
F64 = torch.float64

# ---- the calls every rank makes (and this process makes unsharded) ---------


def _maha_data(seed, n, dtype=F64, consistent=True):
    rng = np.random.default_rng(seed)
    points = rng.uniform(-3, 3, size=(n, 3))
    means = rng.uniform(-3, 3, size=(n, 3))
    sqrt_infos = rng.normal(size=(n, 3, 3))
    if consistent:
        true_pose = port.Pose.from_axis_angle(0.08, [0, 0, 1.0], [-0.15, 0.1, 0.2])
        means = true_pose.apply(points)
    arrays = (points, means, sqrt_infos, np.ones(n))
    return mahalanobis.MahalanobisData(*(torch.tensor(a, dtype=dtype) for a in arrays))


def _p2p_data(seed, n):
    rng = np.random.default_rng(seed)
    points = rng.uniform(-3, 3, size=(n, 3))
    normals = rng.normal(size=(n, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    true_pose = port.Pose.from_axis_angle(0.05, [0.3, 0.2, 1.0], [0.1, -0.05, 0.08])
    means = true_pose.apply(points) + 0.3 * np.cross(normals, rng.normal(size=(n, 3)))
    arrays = (points, means, normals, np.ones(n))
    return point_to_plane.PointToPlaneData(*(torch.tensor(a, dtype=F64) for a in arrays))


def _pose_graph(mesh=None, **kw):
    _, noisy, constraints = testing.generate_pose_graph_fixture()
    opt = tpg.PoseGraphOptimizer(switch_penalty=0.03, device="cpu", mesh=mesh, **kw)
    for i, p in enumerate(noisy):
        opt.set_pose(i, p)
    opt.set_pose_constant(0)
    for c in constraints:
        kind = tpg.ConstraintType.LOOP if c["is_loop"] else tpg.ConstraintType.ODOMETRY
        opt.set_constraint(c["reference_index"], c["query_index"], c["relative_pose"], kind)
    return opt


def _manhattan(mesh, solver):
    """tests/test_torch_pose_graph_2d.py's 150-pose Manhattan world, loops
    (edges spanning >= 20 poses) switchable at penalty 0.03."""
    g, _ = testing.generate_manhattan_g2o(n_poses=150, seed=5)
    opt = tpg.PoseGraphOptimizer2D(switch_penalty=0.03, solver=solver, device="cpu", mesh=mesh)
    for vid in sorted(g.vertices):
        opt.set_pose(vid, g.vertices[vid])
    opt.set_pose_constant(0)
    for e in g.edges:
        kind = tpg.ConstraintType.LOOP if e.j - e.i >= 20 else tpg.ConstraintType.ODOMETRY
        opt.set_constraint(e.i, e.j, e.measurement, kind, sqrt_info=np.sqrt(np.diag(e.information)))
    summary, switches = opt.solve(port.Options().replace(max_iterations=60))
    poses = np.stack([opt.get_pose(i) for i in opt.pose_indices()])
    return {"iterations": int(summary.iterations), "final_cost": float(summary.final_cost),
            "poses": poses, "switches": switches}


def _graph_state(opt, summary, switches):
    poses = np.stack([np.r_[opt.get_pose(i).translation, opt.get_pose(i).quaternion()]
                      for i in range(opt.num_poses)])
    return {"iterations": int(summary.iterations), "final_cost": float(summary.final_cost),
            "poses": poses, "switches": switches}


def _block_system(seed=5, P=60, d=3):
    """A random SPD block system on a chain with extra edges, and its plan."""
    rng = np.random.default_rng(seed)
    ea = list(range(P - 1)) + list(rng.integers(0, P // 2, 30))
    eb = list(range(1, P)) + list(rng.integers(P // 2, P, 30))
    ea, eb = np.array(ea), np.array(eb)
    J = rng.normal(size=(len(ea), d + 1, 2 * d))
    blocks = [np.einsum("eri,erj->eij", J[:, :, a], J[:, :, b])
              for a, b in ((slice(0, d), slice(0, d)), (slice(d, None), slice(d, None)),
                           (slice(0, d), slice(d, None)))]
    diag = rng.uniform(0.5, 2.0, size=(P, d))
    plan = tmf.symbolic(P, ea, eb, d, leaf_size=8)
    return plan, [torch.tensor(x) for x in blocks + [diag]]


def _room():
    pts = testing.generate_room_points(point_step=0.05)
    local = testing.maha_true_pose().inverse().apply(ndt.filter_points(pts, 0.3))
    return pts, local


def _register(pts, local, objective, dtype, mesh=None):
    kw = {"p2p": dict(objective="p2p", max_thickness=0.05), "planar": dict(planar=True)}.get(
        objective, {})
    ndt_map = ndt.build_ndt_map(pts, 1.0, identity_moment=objective != "p2p")
    start = port.Pose(np.eye(3), np.array([0.0, 0.0, 0.05 if objective == "p2p" else 0.0]))
    reg = port.NdtRegistrar(
        ndt_map, port.Options().replace(max_iterations=8), port.ExponentialLoss(),
        max_outer_iterations=2, dtype=dtype, device="cpu", mesh=mesh, **kw,
    )
    res = reg.register(local, start)
    return {"pose": res.pose.matrix(), "outer": res.outer_iterations,
            "inner": res.inner_iterations, "final_cost": res.final_cost}


def _run_checks(mesh, world_of_one_only=False) -> dict:
    """Every sharded call of this file on ``mesh``; with ``mesh=None`` the
    same calls unsharded (a world of one runs the first three, a world of
    four all but the SE(2) CG). Flat dict of numpy results."""
    out = {}
    loss = port.ExponentialLoss()
    opts = port.Options()

    def solved(prefix, pose, summary):
        out[f"{prefix}/pose"] = pose.matrix()
        out[f"{prefix}/iterations"] = int(summary.iterations)
        out[f"{prefix}/final_cost"] = float(summary.final_cost)
        out[f"{prefix}/costs"] = summary.records.cost.numpy()

    def minimizer(cls, **kw):
        return cls(dtype=F64, pad_multiple=8, device="cpu", mesh=mesh, **kw).set_loss_function(loss)

    # tests/test_sharded.py: the full solve, the padding, CG
    solved("maha", *minimizer(port.MahalanobisDistanceMinimizer).solve(
        opts, _maha_data(1, 8 * 128), port.Pose.identity()))
    out["pad5"] = port.MahalanobisDistanceMinimizer(pad_multiple=4, device="cpu", mesh=mesh)._pad(5)
    cg = _pose_graph(mesh, solver="cg")
    out["cg"] = _graph_state(cg, *cg.solve())
    if world_of_one_only:
        return out
    # sharded_quadratic against the local evaluation
    data = _maha_data(0, 8 * 64, consistent=False)
    R = torch.eye(3, dtype=F64)
    t = torch.tensor([0.1, -0.2, 0.05], dtype=F64)
    local = lambda d, R_, t_: mahalanobis.eval_quadratic(R_, t_, d, loss)
    fn = local if mesh is None else parallel.sharded_quadratic(local, mesh)
    for name, x in zip(("H", "g", "cost"), fn(data, R, t)):
        out[f"quadratic/{name}"] = x.numpy()
    # shard_solve: solve_fn gets this rank's rows and the reducer
    solve_fn = lambda d, R_, t_, reduce: reduce(local(d, R_, t_))
    hgc = local(data, R, t) if mesh is None else parallel.shard_solve(solve_fn, mesh, data, R, t)
    for name, x in zip(("H", "g", "cost"), hgc):
        out[f"shard_solve/{name}"] = x.numpy()
    # the other objectives, and priors added once after the sum
    prior_pose = port.Pose.from_axis_angle(0.05, [0, 0, 1.0], [-0.1, 0.1, 0.15])
    solved("maha_priors", *minimizer(port.MahalanobisDistanceMinimizer).set_prior_constraints(
        prior_pose.translation, prior_pose, 50.0, 20.0).solve(
        opts, _maha_data(1, 8 * 128), port.Pose.identity()))
    solved("maha3", *minimizer(port.MahalanobisDistanceMinimizer3DOF).solve(
        opts, _maha_data(2, 8 * 100), port.Pose.identity()))
    pts, pix, intrinsics, _ = testing.generate_reprojection_fixture()
    rdata = reprojection.ReprojectionData(
        torch.tensor(pts), torch.tensor(pix), torch.ones(pts.shape[0], dtype=F64))
    solved("reproj", *minimizer(port.ReprojectionErrorMinimizer).solve(
        opts, rdata, intrinsics, port.Pose.identity()))
    solved("p2p", *minimizer(port.PointToPlaneMinimizer).solve(
        opts, _p2p_data(3, 8 * 90), port.Pose.identity()))
    # the sparse pose graph and the multifrontal factor over the mesh
    sparse = _pose_graph(mesh, solver="sparse")
    out["sparse"] = _graph_state(sparse, *sparse.solve())
    out["sparse2d"] = _manhattan(mesh, "sparse")
    if mesh is None or mesh.size == 2:
        out["cg2d"] = _manhattan(mesh, "cg")
    plan, system = _block_system()
    for dep, (L11, W) in enumerate(tmf.factor(plan, *system, mesh=mesh)):
        out[f"factor/{dep}/L11"], out[f"factor/{dep}/W"] = L11.numpy(), W.numpy()
    # tests/test_fused_sharded.py: the registrar, in float32 and float64
    pts, local = _room()
    for objective in ("maha", "planar", "p2p"):
        for dtype in (torch.float32, F64):
            for k, v in _register(pts, local, objective, dtype, mesh).items():
                out[f"registrar/{objective}/{str(dtype)[6:]}/{k}"] = v
    return out


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _rank_main(rank: int, world: int, work_dir: str) -> None:
    """One rank of a spawned world: join the group, run the checks, write
    ``rank{rank}.npz`` (or ``rank{rank}.err`` with the traceback)."""
    torch.set_num_threads(1)
    try:
        parallel.distributed.initialize(
            "file://" + os.path.join(work_dir, "rendezvous"), world, rank, backend="gloo"
        )
        if not dist.is_initialized():  # a world of one is initialize()'s no-op
            dist.init_process_group(
                "gloo", init_method="file://" + os.path.join(work_dir, "rendezvous"),
                world_size=world, rank=rank,
            )
        try:
            mesh = parallel.make_global_factor_mesh(device="cpu")
            if (mesh.size, mesh.rank, mesh.backend) != (world, rank, "gloo"):
                raise RuntimeError(f"mesh {mesh} in a world of {world}")
            out = _flat(_run_checks(mesh, world_of_one_only=world == 1))
            np.savez(os.path.join(work_dir, f"rank{rank}.npz"), **out)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(work_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


# ---- fixtures --------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world size: [each rank's results]}: the three worlds run at once."""
    ctx = mp.get_context("spawn")
    procs, dirs = [], {}
    for world in WORLDS:
        dirs[world] = str(tmp_path_factory.mktemp(f"world{world}"))
        for rank in range(world):
            proc = ctx.Process(target=_rank_main, args=(rank, world, dirs[world]))
            proc.start()
            procs.append(proc)
    for proc in procs:
        proc.join(timeout=240)
    for proc in procs:
        if proc.is_alive():
            proc.kill()
    errors = [open(os.path.join(d, f)).read() for d in dirs.values()
              for f in sorted(os.listdir(d)) if f.endswith(".err")]
    assert not errors, "\n".join(errors)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return {
        world: [dict(np.load(os.path.join(dirs[world], f"rank{r}.npz"))) for r in range(world)]
        for world in WORLDS
    }


@pytest.fixture(scope="module")
def unsharded():
    return _flat(_run_checks(None))


def _sharded_worlds(worlds):
    return [(w, worlds[w][0]) for w in WORLDS if w > 1]


# ---- tests/test_sharded.py ----------------------------------------------------


def test_sharded_quadratic_matches_local(worlds, unsharded):
    """sharded_quadratic and shard_solve against the local evaluation."""
    for world, got in _sharded_worlds(worlds):
        for name in ("H", "g", "cost"):
            for fn in ("quadratic", "shard_solve"):
                np.testing.assert_allclose(
                    got[f"{fn}/{name}"], unsharded[f"quadratic/{name}"], rtol=1e-12,
                    err_msg=f"world {world}: {fn} {name}",
                )


def test_sharded_full_solve_matches_unsharded(worlds, unsharded):
    """The whole LM loop runs on every rank; pose and cost match the
    unsharded solve at float64, and JAX's solve sharded over its 8-device
    virtual mesh."""
    import jax
    import jax.numpy as jnp

    import nonlinear_optimizer_for_slam_tpu as nls
    from nonlinear_optimizer_for_slam_tpu.core import ExponentialLoss, Options
    from nonlinear_optimizer_for_slam_tpu.ops import mahalanobis as jmaha
    from nonlinear_optimizer_for_slam_tpu.parallel import make_factor_mesh

    assert len(jax.devices()) == 8
    data = _maha_data(1, 8 * 128)
    jdata = jmaha.MahalanobisData(*(jnp.asarray(a.numpy()) for a in data))
    jmin = nls.MahalanobisDistanceMinimizer(
        dtype=jnp.float64, pad_multiple=8, mesh=make_factor_mesh()
    ).set_loss_function(ExponentialLoss())
    jpose, jsum = jmin.solve(Options(), jdata, nls.Pose.identity())
    for world, got in _sharded_worlds(worlds):
        for want in (unsharded, {"maha/pose": jpose.matrix(),
                                 "maha/iterations": int(jsum.iterations),
                                 "maha/final_cost": float(jsum.final_cost)}):
            assert int(got["maha/iterations"]) == int(want["maha/iterations"]), world
            np.testing.assert_allclose(got["maha/pose"], want["maha/pose"], atol=1e-10)
            np.testing.assert_allclose(got["maha/final_cost"], want["maha/final_cost"], rtol=1e-10)
    true_pose = port.Pose.from_axis_angle(0.08, [0, 0, 1.0], [-0.15, 0.1, 0.2])
    np.testing.assert_allclose(worlds[4][0]["maha/pose"][:3, 3], true_pose.translation, atol=1e-4)


def test_mesh_padding_multiple(worlds):
    # 5 rows padded to a multiple of pad_multiple (4) times the world size
    assert [int(worlds[w][0]["pad5"]) for w in WORLDS] == [8, 8, 16]
    mesh = parallel.make_factor_mesh(device="cpu")  # no process group: a world of one
    assert (mesh.size, mesh.rank, mesh.backend, mesh.devices.size) == (1, 0, None, 1)
    assert port.MahalanobisDistanceMinimizer(pad_multiple=4, device="cpu", mesh=mesh)._pad(3) == 4
    assert parallel.factor_sharding(mesh, 8) == slice(0, 8)
    with pytest.raises(ValueError, match="pad them first"):
        parallel.factor_sharding(parallel.FactorMesh(None, 1, 2, torch.device("cpu"), "gloo"), 5)
    blocks = [parallel.row_block(parallel.FactorMesh(None, r, 4, torch.device("cpu"), "gloo"), 5)
              for r in range(4)]
    assert blocks == [slice(0, 2), slice(2, 4), slice(4, 5), slice(5, 5)]


def test_sharded_pose_graph_cg_matches_unsharded(worlds, unsharded):
    """Edges sharded, every edge reduction summed: the CG solve of the
    80-pose fixture iteration for iteration, planted outlier included."""
    for world, got in _sharded_worlds(worlds):
        assert int(got["cg/iterations"]) == int(unsharded["cg/iterations"]), world
        np.testing.assert_allclose(got["cg/final_cost"], unsharded["cg/final_cost"], rtol=1e-9)
        np.testing.assert_allclose(got["cg/poses"][:, :3], unsharded["cg/poses"][:, :3], atol=1e-7)
        np.testing.assert_allclose(got["cg/switches"], unsharded["cg/switches"], atol=1e-8)
        assert got["cg/switches"][-1] < 0.1
        if world != 2:
            continue
        # the SE(2) optimizer's CG path, sharded the same way
        assert int(got["cg2d/iterations"]) == int(unsharded["cg2d/iterations"]), world
        np.testing.assert_allclose(got["cg2d/final_cost"], unsharded["cg2d/final_cost"], rtol=1e-9)
        np.testing.assert_allclose(got["cg2d/poses"], unsharded["cg2d/poses"], atol=1e-7)
        np.testing.assert_allclose(got["cg2d/switches"], unsharded["cg2d/switches"], atol=1e-8)
    with pytest.raises(ValueError, match="mesh"):
        tpg.PoseGraphOptimizer(solver="dense", mesh=parallel.make_factor_mesh(device="cpu"),
                               device="cpu")


# ---- beyond the JAX tests: every objective, priors, sparse, replication ------


def test_sharded_minimizers_every_objective(worlds, unsharded):
    """maha with priors (added once, after the sum), the planar 3-DoF,
    PnP and point-to-plane minimizers: counts equal, poses 1e-10."""
    for world, got in _sharded_worlds(worlds):
        for prefix in ("maha_priors", "maha3", "reproj", "p2p"):
            assert int(got[f"{prefix}/iterations"]) == int(unsharded[f"{prefix}/iterations"]), (
                world, prefix)
            np.testing.assert_allclose(got[f"{prefix}/pose"], unsharded[f"{prefix}/pose"],
                                       atol=1e-10, err_msg=f"world {world}: {prefix}")
            np.testing.assert_allclose(got[f"{prefix}/final_cost"],
                                       unsharded[f"{prefix}/final_cost"], rtol=1e-10)


def test_sharded_sparse_and_factor_bitwise(worlds, unsharded):
    """Fronts factored block by block over the ranks and gathered: the
    factor and the sparse pose-graph solve are the unsharded ones, bit for
    bit."""
    for world, got in _sharded_worlds(worlds):
        keys = [k for k in unsharded if k.startswith(("factor/", "sparse/", "sparse2d/"))]
        assert keys and all(k in got for k in keys)
        for k in keys:
            np.testing.assert_array_equal(got[k], unsharded[k], err_msg=f"world {world}: {k}")


def test_ranks_bitwise_equal(worlds):
    """The sum in rank order leaves every rank the same bits, so every
    result of every rank is equal."""
    for world in WORLDS:
        first = worlds[world][0]
        for rank, other in enumerate(worlds[world][1:], 1):
            assert sorted(other) == sorted(first)
            for k in first:
                np.testing.assert_array_equal(other[k], first[k], err_msg=f"{world}/{rank}: {k}")


def test_world_of_one_is_unsharded(worlds, unsharded):
    """A world of one adds one partial: its solves are the unsharded ones
    bit for bit."""
    got = worlds[1][0]
    for k in got:
        np.testing.assert_array_equal(got[k], unsharded[k], err_msg=k)


# ---- tests/test_fused_sharded.py ------------------------------------------------


def test_sharded_fused_matches_single_device(worlds, unsharded):
    for world, got in _sharded_worlds(worlds):
        for objective in ("maha", "planar", "p2p"):
            for dtype, atol in (("float32", 1e-4), ("float64", 1e-9)):
                key = f"registrar/{objective}/{dtype}"
                assert int(got[f"{key}/outer"]) == int(unsharded[f"{key}/outer"]), (world, key)
                np.testing.assert_array_equal(got[f"{key}/inner"], unsharded[f"{key}/inner"])
                np.testing.assert_allclose(got[f"{key}/pose"], unsharded[f"{key}/pose"],
                                           atol=atol, err_msg=f"world {world}: {key}")


def test_shard_edges_pads_and_numbers_loops_globally():
    """The union of the ranks' edge blocks is the padded edge set (masked
    identity edges between poses 0 and 1), the loop slots numbered over
    the whole graph: for SE(3) and SE(2) edges, with and without
    sqrt-information."""
    edges3 = _pose_graph(None, solver="cg")._flatten()["edges_dev"]
    g, _ = testing.generate_manhattan_g2o(n_poses=60, seed=5)
    opt2 = tpg.PoseGraphOptimizer2D(switch_penalty=0.03, solver="cg", device="cpu")
    for vid in sorted(g.vertices):
        opt2.set_pose(vid, g.vertices[vid])
    for e in g.edges:
        kind = tpg.ConstraintType.LOOP if e.j - e.i >= 20 else tpg.ConstraintType.ODOMETRY
        opt2.set_constraint(e.i, e.j, e.measurement, kind, sqrt_info=np.sqrt(np.diag(e.information)))
    edges2 = opt2._flat_2d()[-1]
    for edges, P in ((edges3, 80), (edges2, 60)):
        E = edges.num_edges
        L = int((edges.is_loop > 0).sum())
        blocks = [tpg._shard_edges(edges, parallel.FactorMesh(None, r, 4, torch.device("cpu"), "gloo"),
                                   P, L) for r in range(4)]
        whole = type(edges)(*(None if f[0] is None else torch.cat(f) for f in
                              zip(*[b[0] for b in blocks])))
        slots = torch.cat([b[1] for b in blocks])
        pad = -E % 4
        assert whole.num_edges == E + pad
        for field, got, want in zip(edges._fields, whole, edges):
            if want is not None:
                assert torch.equal(got[:E], want), field
        assert torch.equal(slots[:E], tpg._loop_slot(edges.is_loop, L))
        assert not whole.mask[E:].any() and not whole.is_loop[E:].any()
        assert (whole.reference_indices[E:] == 0).all() and (whole.query_indices[E:] == 1).all()
        if edges.sqrt_info is not None:
            assert (whole.sqrt_info[E:] == 1.0).all()


def test_distributed_world_of_one_is_a_no_op():
    parallel.distributed.initialize(world_size=1)
    assert not dist.is_initialized()
    assert parallel.process_info() == {
        "process_index": 0, "process_count": 1,
        "local_devices": torch.cuda.device_count() if torch.cuda.is_available() else 0,
        "global_devices": 1, "backend": None,
    }
    mesh = parallel.make_global_factor_mesh(device="cpu")
    tree = (torch.ones(2), (torch.zeros(3), None))
    assert parallel.all_sum(mesh, tree) is tree  # no process group: nothing exchanged


def test_registrar_mesh_refusals():
    pts = testing.generate_room_points(point_step=0.2)
    ndt_map = ndt.build_ndt_map(pts, 1.0)
    mesh = parallel.make_factor_mesh(device="cpu")
    with pytest.raises(NotImplementedError, match="map_pad_multiple with mesh"):
        port.NdtRegistrar(ndt_map, port.Options(), device="cpu", mesh=mesh, map_pad_multiple=64)
    reg = port.NdtRegistrar(ndt_map, port.Options(), device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match="one NdtRegistrar per replica"):
        reg.register_batch([pts[:10]], [port.Pose.identity()])
