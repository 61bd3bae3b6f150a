"""The port's multi-device tier against the JAX package's, on the CPU.

Four ranks run the port, one process each (``torch.multiprocessing``
spawn, gloo over a ``file://`` store, one thread a rank); the JAX side
runs in the test process under ``shard_map`` on four of conftest's eight
virtual CPU devices, as ``tests/test_parallel.py`` calls it. The same
inputs, made from a seed with numpy, go to both. Cases:

- ``reshard_balance_cols`` and ``route_rows_home`` bitwise equal to JAX's
  on random state, for a gross and a mild imbalance (``need`` equal too);
- the sharded ``pt_trace_frame`` and ``whitted_trace_frame`` at 128x128,
  depth 3, on the ``mxu`` engine, with half the ranks' lanes dead: port
  against JAX through the two-class gate, traced per rank within 0.5%,
  the same reshard decision;
- reshard on against off, bitwise, with ``mxu`` and ``sparse`` bounces:
  rays conserved, the idle half gains work, the busiest rank is relieved;
  a mild imbalance does not fire;
- both renderers at ``mesh_shape=(4,)``: one image on every rank, JAX's
  renderer's buffer through the gate, counters summed, ``dropped == 0``;
  the per-wave body's keys, ``info``, ``set_frame_buffer``, ``render()``
  rebinds, scene replication, ``sharded_wave`` and ``create_context``'s
  checks.

This module imports JAX only inside the functions that run the JAX side,
so a rank process, which imports it to find its function, never does.
"""

import datetime
import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from rayaccel_tpu_torch.tools.oracle_lib import two_class_gate

D = 4
SIZE, DEPTH, LANES = 128, 3, 128 * 128      # the frames: one wave
N = LANES // D                              # a rank's lanes
RSIZE = 128                                 # the renderers
RDEPTH = dict(pt=2, whitted=DEPTH)
RENDER_KEYS = (11, 12)
FRAME_KEY = 7
RANK_TIMEOUT = 120                          # seconds a collective may wait
JOB_TIMEOUT = 300                           # seconds the whole job may take
WHITTED_FRAME = dict(stack_size=4, min_stage_width=1024)


# ---- the launcher ----

def _rank_main(rank, fn, store, out_dir, args):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=D,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
    try:
        result = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


class Job:
    """``fn(rank, *args)`` on D spawned ranks of one gloo group. A rank
    that raises, or a job past ``timeout`` seconds, kills every rank and
    fails :meth:`results`."""

    def __init__(self, fn, tmp, *args, timeout=JOB_TIMEOUT):
        self.out_dir = str(tmp)
        self.deadline = time.monotonic() + timeout
        self.ctx = mp.start_processes(
            _rank_main, args=(fn, os.path.join(self.out_dir, "store"),
                              self.out_dir, args),
            nprocs=D, join=False, start_method="spawn")

    def kill(self):
        for p in self.ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)

    def results(self):
        try:
            while not self.ctx.join(timeout=1):
                if time.monotonic() > self.deadline:
                    codes = [p.exitcode for p in self.ctx.processes]
                    raise TimeoutError(f"the ranks did not finish: {codes}")
        finally:
            self.kill()
        out = []
        for r in range(D):
            with open(os.path.join(self.out_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# ---- the inputs, one set for both packages ----

def _interleaved(perm, x, y):
    """The frame's lanes dealt round-robin to the ranks, so that every
    rank holds as much sky and geometry as the others."""
    order = np.arange(LANES).reshape(D, N).T.ravel()
    return perm[order], x[order], y[order]


def make_inputs():
    from rayaccel_tpu.scene.clusters import compile_clusters
    from rayaccel_tpu.scene.loader import make_test_scene
    from rayaccel_tpu_torch.render.tiled import block_swizzle
    from tests.torch_helpers import CLUSTER_FIELDS

    sd = make_test_scene(viewport=(SIZE, SIZE), max_depth=DEPTH)
    jcs = compile_clusters(sd, cluster_size=32)
    perm, x, y = block_swizzle(SIZE, SIZE, LANES)
    lanes = np.arange(LANES)
    ip, ix, iy = _interleaved(perm, x, y)
    frames = dict(
        # Half the ranks' lanes dead: ranks 0-1 carry every live ray.
        gross=(x, y, (perm >= 0) & (lanes < LANES // 2)),
        # Every rank holds a mix of sky and geometry; 5% of rank 3 dead.
        mild=(ix, iy, (ip >= 0) & ~(lanes >= LANES - N // 20)))
    rs = np.random.default_rng(20)
    reshard = {}
    for name, p_live in (("gross", (0.9, 0.9, 0.05, 0.05)),
                         ("mild", (0.8, 0.8, 0.8, 0.75))):
        alive = np.concatenate([rs.random(256 * D) < p for p in p_live])
        reshard[name] = (rs.standard_normal((256 * D * D, 19))
                         .astype(np.float32),
                         np.arange(256 * D * D, dtype=np.int32), alive)
    return dict(
        renderer_perm=block_swizzle(RSIZE, RSIZE, RSIZE * RSIZE)[0],
        scene={f: np.asarray(getattr(jcs, f)) for f in CLUSTER_FIELDS},
        env=np.asarray(sd.env_pixels), frames=frames, reshard=reshard,
        route_cols=rs.standard_normal((256 * D * D, 3)).astype(np.float32))


# ---- the port's side, in each rank ----

def _port_scene(inputs, device="cpu"):
    from rayaccel_tpu_torch.environment import create_environment
    from rayaccel_tpu_torch.scene.clusters import cluster_scene_from_numpy
    px = inputs["env"]
    return (cluster_scene_from_numpy(**inputs["scene"], device=device),
            create_environment(px, px.shape[1], px.shape[0], device=device))


def _camera(size):
    import rayaccel_tpu_torch as racc
    from rayaccel_tpu_torch.scene.loader import make_test_scene
    sd = make_test_scene(viewport=(size, size), max_depth=DEPTH)
    return racc.Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                               sd.cam_fov, size, size)


def _port_mesh_ops(mesh, rank, inputs):
    from rayaccel_tpu_torch.parallel.mesh import (reshard_balance_cols,
                                                  route_rows_home)
    out = {}
    rows = slice(rank * 256 * D, (rank + 1) * 256 * D)
    for name, (S, lane, alive) in inputs["reshard"].items():
        S2, lane2, need = reshard_balance_cols(
            torch.tensor(S[rows]), torch.tensor(lane[rows]),
            torch.tensor(alive[rows]), mesh, D)
        out[name] = (S2.numpy(), lane2.numpy(), need)
    lane2 = out["gross"][1]
    routed = route_rows_home(
        torch.cat([torch.tensor(lane2, dtype=torch.float32)[:, None],
                   torch.tensor(inputs["route_cols"][rows])], dim=1),
        mesh, True)
    out["routed"] = routed.numpy()
    return out


def _port_frames(mesh, rank, inputs):
    from rayaccel_tpu_torch import rng
    from rayaccel_tpu_torch.render.pathtracer import pt_trace_frame
    from rayaccel_tpu_torch.render.whitted import whitted_trace_frame
    cs, env = _port_scene(inputs)
    cam = _camera(SIZE).as_arrays("cpu")
    out = {}
    sl = slice(rank * N, (rank + 1) * N)
    for case, (x, y, alive) in inputs["frames"].items():
        xs, ys, al = (torch.as_tensor(a[None, sl]) for a in (x, y, alive))
        xs, ys = xs.to(torch.int32), ys.to(torch.int32)
        for kind, fn, kw in (("pt", pt_trace_frame, {}),
                             ("whitted", whitted_trace_frame,
                              WHITTED_FRAME)):
            for bounce in ("mxu", "sparse") if case == "gross" else ("mxu",):
                for reshard in (True, False):
                    info = {}
                    rad, traced, dropped = fn(
                        cs, env, cam, xs, ys, al, rng.PRNGKey(FRAME_KEY),
                        DEPTH, backend="mxu", tile=512, bounce_backend=bounce,
                        mesh=mesh, n_shards=D, reshard=reshard, info=info,
                        **kw)
                    out[kind, case, bounce, reshard] = dict(
                        rad=rad.numpy(), traced=int(traced),
                        dropped=int(dropped), resharded=info["resharded"])
    return out


def _port_renderers(mesh_ctx, rank, inputs):
    import rayaccel_tpu_torch as racc
    from rayaccel_tpu_torch import rng
    from rayaccel_tpu_torch.scene.loader import make_test_scene
    cs, _ = _port_scene(inputs)
    out = {}
    for kind, depth in RDEPTH.items():
        sd = make_test_scene(viewport=(RSIZE, RSIZE), max_depth=depth)
        cls = (racc.PathTracingRenderer if kind == "pt"
               else racc.WhittedRenderer)
        r = cls(mesh_ctx, _camera(RSIZE), sd, tpu_scene=cs)
        stats = [int(r.render_frame(rng.PRNGKey(k)).rays_traced)
                 for k in RENDER_KEYS]
        fb = r.frame_buffer.clone()
        out[kind] = dict(image=r.image(), frame_buffer=fb.numpy(),
                         stats=stats, rays_traced_total=r.rays_traced_total,
                         dropped=r.dropped, pooled=r.pooled,
                         lanes=r._wave_x.shape[1])
        # Restoring the gathered buffer gives this rank its lanes back.
        r.clear()
        r.set_frame_buffer(fb.numpy())
        out[kind]["restored"] = bool(torch.equal(r.frame_buffer, fb))
    return out


def _port_per_wave(rank, inputs):
    """The per-wave body under the mesh (``regroup=False``): this rank's
    lanes of each wave, keyed ``fold_in(fold_in(key, rank), w)``."""
    import rayaccel_tpu_torch as racc
    from rayaccel_tpu_torch import rng
    from rayaccel_tpu_torch.render.pathtracer import pt_trace_wave
    from rayaccel_tpu_torch.scene.loader import make_test_scene
    cs, _ = _port_scene(inputs)
    ctx = racc.create_context(racc.Configuration(
        mesh_shape=(D,), backend="mxu", hybrid_tracing=False, regroup=False,
        wave_size=RSIZE * RSIZE // 2, trace_block=512), device="cpu")
    sd = make_test_scene(viewport=(RSIZE, RSIZE), max_depth=2)
    r = racc.PathTracingRenderer(ctx, _camera(RSIZE), sd, tpu_scene=cs)
    stats = r.render_frame(rng.PRNGKey(5))
    key = rng.fold_in(rng.PRNGKey(5), rank)
    waves = [pt_trace_wave(r.scene, r.environment,
                           r.camera.as_arrays("cpu"), r._wave_x[w],
                           r._wave_y[w], r._wave_alive[w],
                           rng.fold_in(key, w), 2,
                           backend="mxu", tile=r.tile)
             for w in range(r.n_waves)]
    return dict(pooled=r.pooled, waves=r.n_waves,
                equal=bool(torch.equal(r._fb3, torch.stack(
                    [w[0] for w in waves]))),
                traced=int(stats.rays_traced),
                local_traced=sum(int(w[1]) for w in waves))


def _port_rebind(mesh_ctx, rank, inputs):
    """``render()`` with a scene and an environment that differ on every
    rank: every rank traces rank 0's afterwards."""
    import rayaccel_tpu_torch as racc
    from rayaccel_tpu_torch import rng
    from rayaccel_tpu_torch.scene.loader import make_test_scene
    cs, env = _port_scene(inputs)
    sd = make_test_scene(viewport=(RSIZE, RSIZE), max_depth=2)
    r = racc.PathTracingRenderer(mesh_ctx, _camera(RSIZE), sd, tpu_scene=cs)
    mine = cs._replace(G=cs.G + rank, mat_params=cs.mat_params * (1 + rank))
    env_mine = env._replace(quad=env.quad * (1 + rank))
    racc.render(mesh_ctx, mine, env_mine, r, key=rng.PRNGKey(3))
    bound = r._bound_scene is mine and r._bound_env is env_mine
    scene_now, env_now = r.scene, r.environment
    # The bound objects again: nothing is replicated.
    racc.render(mesh_ctx, mine, env_mine, r, key=rng.PRNGKey(4))
    return dict(bound=bound, again=r.scene is scene_now
                and r.environment is env_now,
                G=r.scene.G.numpy(), mat=r.scene.mat_params.numpy(),
                quad=r.environment.quad.numpy(), spp=r.spp,
                image=r.image())


def _port_side(rank, inputs):
    import rayaccel_tpu_torch as racc
    from rayaccel_tpu_torch.parallel.mesh import (make_mesh, replicate_scene,
                                                  sharded_wave)
    out = {}
    # create_context refuses a mesh the group does not match.
    try:
        racc.create_context(racc.Configuration(mesh_shape=(2,)),
                            device="cpu")
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    mesh = make_mesh("cpu", D)
    out["mesh"] = (mesh.rank, mesh.size, mesh.backend,
                   dist.get_backend(mesh.group))
    out["ops"] = _port_mesh_ops(mesh, rank, inputs)
    cs, _ = _port_scene(inputs)
    rep = replicate_scene(mesh, cs._replace(G=cs.G * (rank + 1)))
    out["replicated_G"] = rep.G.numpy()

    def wave_fn(fb, base, key):
        return fb + base, torch.tensor(key * 10 + base)

    fb, traced = sharded_wave(mesh, wave_fn, 8 * D)(
        torch.zeros((8, 3)), rank, rank + 1)
    out["sharded_wave"] = (fb.numpy(), int(traced))
    out["frames"] = _port_frames(mesh, rank, inputs)
    ctx = racc.create_context(racc.Configuration(
        mesh_shape=(D,), backend="mxu", hybrid_tracing=False,
        wave_size=RSIZE * RSIZE, trace_block=512, min_stage_width=1024),
        device="cpu")
    out["info"] = racc.info(ctx)
    out["device_count"] = ctx.device_count
    out["renderers"] = _port_renderers(ctx, rank, inputs)
    out["rebind"] = _port_rebind(ctx, rank, inputs)
    out["per_wave"] = _port_per_wave(rank, inputs)
    return out


# ---- the JAX side, in the test process ----

def _jax_mesh():
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:D]), ("tiles",))


def _jax_mesh_ops(inputs):
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from rayaccel_tpu.parallel.mesh import (reshard_balance_cols,
                                            route_rows_home)
    mesh = _jax_mesh()

    @jax.jit
    @partial(shard_map, mesh=mesh, in_specs=(P("tiles"),) * 4,
             out_specs=(P("tiles"),) * 4, check_vma=False)
    def fn(S, lane, alive, cols):
        S2, lane2, need = reshard_balance_cols(S, lane, alive, "tiles", D)
        rows = jnp.concatenate([lane2.astype(jnp.float32)[:, None], cols],
                               axis=1)
        return S2, lane2, need[None], route_rows_home(rows, "tiles", True)

    out = {}
    for name, (S, lane, alive) in inputs["reshard"].items():
        S2, lane2, need, routed = fn(S, lane, alive, inputs["route_cols"])
        out[name] = (np.asarray(S2), np.asarray(lane2), np.asarray(need))
        if name == "gross":
            out["routed"] = np.asarray(routed)
    return out


def _jax_frames(inputs):
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from rayaccel_tpu.camera import Camera
    from rayaccel_tpu.environment import create_environment
    from rayaccel_tpu.parallel.mesh import replicate_scene
    from rayaccel_tpu.render.pathtracer import pt_trace_frame
    from rayaccel_tpu.render.whitted import whitted_trace_frame
    from rayaccel_tpu.scene.clusters import ClusterScene
    from rayaccel_tpu.scene.loader import make_test_scene

    mesh = _jax_mesh()
    sd = make_test_scene(viewport=(SIZE, SIZE), max_depth=DEPTH)
    scene = replicate_scene(mesh, ClusterScene(
        **{k: jnp.asarray(v) for k, v in inputs["scene"].items()}))
    px = inputs["env"]
    env = replicate_scene(mesh, create_environment(px, px.shape[1],
                                                   px.shape[0]))
    cam = Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up, sd.cam_fov,
                         SIZE, SIZE).as_arrays()
    x, y, alive = inputs["frames"]["gross"]
    args = (jnp.asarray(x[None], jnp.int32), jnp.asarray(y[None], jnp.int32),
            jnp.asarray(alive[None]), jax.random.PRNGKey(FRAME_KEY))
    out = {}
    for kind, impl, kw in (("pt", pt_trace_frame, {}),
                           ("whitted", whitted_trace_frame, WHITTED_FRAME)):
        @jax.jit
        @partial(shard_map, mesh=mesh,
                 in_specs=(P(None, "tiles"),) * 3 + (P(),),
                 out_specs=(P(None, "tiles"), P("tiles"), P("tiles")),
                 check_vma=False)
        def fn(xs, ys, alives, key, impl=impl, kw=kw):
            rad, traced, dropped = impl(
                scene, env, cam, xs, ys, alives, key, max_depth=DEPTH,
                backend="mxu", tile=512, bounce_backend="mxu",
                mesh_axis="tiles", n_shards=D, reshard=True, **kw)
            return rad, traced[None], dropped[None]

        rad, traced, dropped = fn(*args)
        out[kind] = dict(rad=np.asarray(rad).reshape(LANES, 3),
                         traced=np.asarray(traced),
                         dropped=np.asarray(dropped))
    return out


def _jax_renderers(inputs):
    import jax
    import jax.numpy as jnp
    import rayaccel_tpu as jracc
    from rayaccel_tpu.scene.clusters import ClusterScene
    from rayaccel_tpu.scene.loader import make_test_scene

    jcs = ClusterScene(**{k: jnp.asarray(v)
                          for k, v in inputs["scene"].items()})
    ctx = jracc.create_context(jracc.Configuration(
        mesh_shape=(D,), backend="mxu", hybrid_tracing=False,
        wave_size=RSIZE * RSIZE, trace_block=512, min_stage_width=1024))
    out = {}
    for kind, depth in RDEPTH.items():
        sd = make_test_scene(viewport=(RSIZE, RSIZE), max_depth=depth)
        cam = jracc.Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                                   sd.cam_fov, RSIZE, RSIZE)
        cls = (jracc.PathTracingRenderer if kind == "pt"
               else jracc.WhittedRenderer)
        r = cls(ctx, cam, sd, tpu_scene=jcs)
        stats = [int(r.render_frame(jax.random.PRNGKey(k)).rays_traced)
                 for k in RENDER_KEYS]
        out[kind] = dict(image=r.image(), stats=stats,
                         frame_buffer=np.asarray(r.frame_buffer),
                         dropped=r.dropped)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's result on each rank, the JAX side's): the ranks run
    while the test process compiles and runs JAX."""
    inputs = make_inputs()
    job = Job(_port_side, tmp_path_factory.mktemp("ranks"), inputs)
    try:
        ref = dict(ops=_jax_mesh_ops(inputs), frames=_jax_frames(inputs),
                   renderers=_jax_renderers(inputs))
    except BaseException:
        job.kill()
        raise
    return job.results(), ref, inputs


# ---- the cases ----

def test_mesh_is_a_gloo_group_of_every_rank(runs):
    port, _, _ = runs
    assert [p["mesh"] for p in port] == [(r, D, "gloo", "gloo")
                                         for r in range(D)]


@pytest.mark.parametrize("case", ["gross", "mild"])
def test_reshard_balance_cols_matches_jax(runs, case):
    port, ref, _ = runs
    S = np.concatenate([p["ops"][case][0] for p in port])
    lane = np.concatenate([p["ops"][case][1] for p in port])
    need = [p["ops"][case][2] for p in port]
    np.testing.assert_array_equal(S, ref["ops"][case][0])
    np.testing.assert_array_equal(lane, ref["ops"][case][1])
    assert need == ref["ops"][case][2].tolist() == [case == "gross"] * D


def test_route_rows_home_matches_jax(runs):
    port, ref, _ = runs
    routed = np.concatenate([p["ops"]["routed"] for p in port])
    np.testing.assert_array_equal(routed, ref["ops"]["routed"])
    # Every rank holds the rows of its own lanes again.
    n = 256 * D
    for r, p in enumerate(port):
        np.testing.assert_array_equal(np.sort(p["ops"]["routed"][:, 0]),
                                      np.arange(r * n, (r + 1) * n))


@pytest.mark.parametrize("kind", ["pt", "whitted"])
def test_sharded_frame_matches_jax(runs, kind):
    port, ref, inputs = runs
    got = [p["frames"][kind, "gross", "mxu", True] for p in port]
    want = ref["frames"][kind]
    rad = np.concatenate([g["rad"].reshape(N, 3) for g in got])
    valid = inputs["frames"]["gross"][2]
    gate = two_class_gate(rad[valid], want["rad"][valid])
    assert gate["rmse_trimmed"] < 1e-3 and gate["frac_flip"] < 0.005, gate
    traced = np.array([g["traced"] for g in got])
    assert np.all(np.abs(traced - want["traced"])
                  <= 0.005 * np.maximum(want["traced"], 1)), (traced,
                                                              want["traced"])
    # Without the exchange the dead ranks trace nothing at all.
    jax_resharded = bool(want["traced"][D // 2:].sum() > 0)
    assert [g["resharded"] for g in got] == [jax_resharded] * D == [True] * D
    assert [g["dropped"] for g in got] == want["dropped"].tolist() == [0] * D


@pytest.mark.parametrize("bounce", ["mxu", "sparse"])
@pytest.mark.parametrize("kind", ["pt", "whitted"])
def test_reshard_on_off_bitwise_and_balances(runs, kind, bounce):
    """With half the ranks' lanes dead the exchange fires, moves bounce
    work onto the idle ranks and leaves the radiance bitwise unchanged:
    the bounce draws are keyed by global lane id (Whitted draws none)."""
    port, _, _ = runs
    on = [p["frames"][kind, "gross", bounce, True] for p in port]
    off = [p["frames"][kind, "gross", bounce, False] for p in port]
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a["rad"], b["rad"])
        assert a["dropped"] == b["dropped"] == 0
    assert all(a["resharded"] for a in on)
    assert not any(b["resharded"] for b in off)
    t_on = np.array([a["traced"] for a in on])
    t_off = np.array([b["traced"] for b in off])
    assert t_on.sum() == t_off.sum(), "ray conservation"
    assert t_on[D // 2:].sum() > t_off[D // 2:].sum(), (t_off, t_on)
    assert t_on.max() < t_off.max(), (t_off, t_on)


@pytest.mark.parametrize("kind", ["pt", "whitted"])
def test_mild_imbalance_does_not_fire(runs, kind):
    port, _, _ = runs
    on = [p["frames"][kind, "mild", "mxu", True] for p in port]
    off = [p["frames"][kind, "mild", "mxu", False] for p in port]
    assert not any(a["resharded"] for a in on)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a["rad"], b["rad"])
        assert a["traced"] == b["traced"] and a["dropped"] == 0
    # Every rank held live lanes after stage 1.
    assert min(a["traced"] for a in on) > N


@pytest.mark.parametrize("kind", ["pt", "whitted"])
def test_renderer_matches_jax(runs, kind):
    port, ref, inputs = runs
    got = [p["renderers"][kind] for p in port]
    want = ref["renderers"][kind]
    for g in got[1:]:
        np.testing.assert_array_equal(g["image"], got[0]["image"])
        np.testing.assert_array_equal(g["frame_buffer"],
                                      got[0]["frame_buffer"])
    assert all(g["lanes"] == RSIZE * RSIZE // D and g["pooled"]
               for g in got)
    # The accumulated buffers, in the JAX renderer's (and checkpoint's)
    # lane order: a winner flip keeps its full size in a sum of frames,
    # where the image's mean over frames would shrink it below the gate's
    # flip class.
    gate = two_class_gate(got[0]["frame_buffer"], want["frame_buffer"])
    assert gate["rmse_trimmed"] < 1e-3 and gate["frac_flip"] < 0.005, gate
    img = np.zeros((RSIZE * RSIZE, 3), np.float32)
    valid = inputs["renderer_perm"] >= 0
    img[inputs["renderer_perm"][valid]] = got[0]["frame_buffer"][valid]
    np.testing.assert_array_equal(
        got[0]["image"], img.reshape(RSIZE, RSIZE, 3) / len(RENDER_KEYS))
    # Every rank reports the frame's total; it is JAX's within 0.5%.
    assert all(g["stats"] == got[0]["stats"] for g in got)
    assert all(g["rays_traced_total"] == sum(got[0]["stats"]) for g in got)
    assert np.all(np.abs(np.subtract(got[0]["stats"], want["stats"]))
                  <= 0.005 * np.asarray(want["stats"]))
    assert [g["dropped"] for g in got] == [0] * D and want["dropped"] == 0
    assert np.isfinite(got[0]["image"]).all() and got[0]["image"].max() > 0


@pytest.mark.parametrize("kind", ["pt", "whitted"])
def test_set_frame_buffer_round_trips_under_the_mesh(runs, kind):
    port, _, _ = runs
    assert all(p["renderers"][kind]["restored"] for p in port)


def test_info_counts_the_ranks(runs):
    port, _, _ = runs
    assert {p["info"].device_count for p in port} == {D}
    assert port[0]["info"].backend == "mxu"


def test_device_count_counts_the_ranks(runs):
    """``Context.device_count`` is the mesh's size on every rank, as
    ``info`` reports it."""
    port, _, _ = runs
    assert [p["device_count"] for p in port] == [D] * D
    assert all(p["device_count"] == p["info"].device_count for p in port)


def test_per_wave_body_folds_the_rank_before_the_wave(runs):
    port, _, _ = runs
    pw = [p["per_wave"] for p in port]
    assert all(p["equal"] and not p["pooled"] and p["waves"] == 2
               for p in pw)
    assert {p["traced"] for p in pw} == {sum(p["local_traced"] for p in pw)}


def test_render_rebinds_under_the_mesh(runs):
    port, _, _ = runs
    rb = [p["rebind"] for p in port]
    assert all(r["bound"] and r["again"] and r["spp"] == 2 for r in rb)
    for r in rb[1:]:
        for k in ("G", "mat", "quad", "image"):
            np.testing.assert_array_equal(r[k], rb[0][k])


def test_replicate_scene_gives_rank_0s_arrays(runs):
    port, _, inputs = runs
    for p in port:
        np.testing.assert_array_equal(p["replicated_G"], inputs["scene"]["G"])


def test_sharded_wave_sums_traced(runs):
    port, _, _ = runs
    for r, p in enumerate(port):
        fb, traced = p["sharded_wave"]
        np.testing.assert_array_equal(fb, np.full((8, 3), r, np.float32))
        assert traced == sum((s + 1) * 10 + s for s in range(D))


def test_create_context_checks_the_group(runs):
    """A group of four refuses a mesh of two; with no group a mesh of four
    is refused and a mesh of one forms its own one-rank group."""
    import rayaccel_tpu_torch as racc
    port, _, _ = runs
    assert all(p["mismatch"] and "2 ranks" in p["mismatch"] for p in port)
    if not dist.is_initialized():
        with pytest.raises(ValueError, match="needs an initialised"):
            racc.create_context(racc.Configuration(mesh_shape=(D,)),
                                device="cpu")
    ctx = racc.create_context(racc.Configuration(mesh_shape=(1,)),
                              device="cpu")
    assert (ctx.mesh.size, ctx.mesh.rank, ctx.mesh.backend) == (1, 0, "gloo")
    assert racc.info(ctx).device_count == 1
    with pytest.raises(ValueError, match=f"{D} ranks"):
        racc.create_context(racc.Configuration(mesh_shape=(D,)),
                            device="cpu")
