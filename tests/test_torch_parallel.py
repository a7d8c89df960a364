"""The port's data parallelism (``prifit_torch/parallel``, the process
group of the batch norms, regions and losses, the sharded loader) on the
CPU: 2 ranks with ``gloo`` on the loopback, started with
``torch.multiprocessing.spawn``.  Inputs are made with numpy from a seed
in the parent; each rank returns numpy arrays through a file.

The steps are held against the JAX package's step on the GLOBAL batch
(one program, what its partitioner computes on a batch-sharded mesh) and
against the port's single-process step on that batch.  Tolerances are
stated where they are used; they are those of the single-process tests
(``test_torch_train.py`` for f32, ``test_torch_mixed.py`` for ``mxsr``),
since two ranks only sum the same terms in another order.

This module imports no JAX at its top: the ranks import it to find their
work (``spawn_run``), and ``test_torch_point_sp.py`` uses the same
harness (and imports no JAX at its top either).
"""

import datetime
import os
import pickle
import socket
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from prifit_torch.data.loader import DataLoader as TLoader
from prifit_torch.data.loader import shard_for_host as t_shard

torch.set_num_threads(1)

B, N, PARTS = 2, 512, 50
LR, BN_MOMENTUM, LMBDA = 1e-3, 0.1, 1.0
SS_KW = dict(quantile=0.05, msc_iterations=1, max_num_clusters=6,
             n_per_prim=32, num_bandwidth_candidates=2)
BASE = (0x2468ACE1, 0x13579BDF)


# ------------------------------------------------------------ the harness

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, task, payload, out_dir):
    torch.set_num_threads(1)
    os.environ["JAX_PLATFORMS"] = "cpu"
    # a collective that finds no partner fails the test within two minutes
    # rather than hanging it
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        result = task(rank, world, payload)
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn_run(world: int, task, payload=None) -> list:
    """Run ``task(rank, world, payload)`` (a module-level function, which
    the ranks import by name) on ``world`` gloo ranks; returns each rank's
    result."""
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(_rank_main, args=(world, _free_port(), task, payload,
                                   out_dir), nprocs=world, join=True)
        out = []
        for r in range(world):
            with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


# ------------------------------------------------------------- rank tasks

def _task_collectives(rank, world, payload):
    """The collectives' values and transposes, and the mesh helpers."""
    from prifit_torch.parallel import (
        batch_sharding,
        make_data_mesh,
        make_mesh,
        replicate,
        shard_batch,
    )
    from prifit_torch.parallel.collectives import (
        all_gather,
        average_gradients,
        ppermute,
        psum,
    )

    g = dist.group.WORLD
    out = {}
    a = torch.tensor([1.0, 2.0], requires_grad=True)
    # sum(cat(all_gather(a (r + 1)))): every rank's loss is the same
    # replicated scalar, so the gradient each rank holds is world times
    # its share, and the average over ranks is the share (the convention)
    y = all_gather(a * (rank + 1), g, 0).sum()
    y.backward()
    out["gather_val"] = y.item()
    out["gather_grad"] = _np(a.grad)
    b = torch.tensor([3.0 + rank], requires_grad=True)
    s = psum(b * b, g)
    s.backward()
    out["psum_val"], out["psum_grad"] = s.item(), b.grad.item()
    c = torch.tensor([10.0 * (rank + 1)], requires_grad=True)
    z = ppermute(c, g, 1)
    (z * (rank + 2)).sum().backward()
    out["perm_val"], out["perm_grad"] = z.item(), c.grad.item()
    p = torch.nn.Parameter(torch.tensor([float(rank)]))
    p.grad = torch.tensor([2.0 * rank])
    average_gradients([p], g)
    out["avg"] = p.grad.item()

    mesh = make_mesh()
    out["mesh"] = (mesh.shape, mesh.coords, mesh.size)
    dm = make_data_mesh(3)          # 3 does not split over 2: one rank
    out["data_mesh"] = (dm.size, dm.member, dm.devices)
    sh = batch_sharding(mesh)
    out["sharding"] = (sh.index, sh.count)
    batch = {"x": np.arange(8).reshape(4, 2), "y": torch.arange(4)}
    part = shard_batch(mesh, batch)
    out["shard"] = (part["x"], _np(part["y"]))
    lin = torch.nn.Linear(2, 2)
    with torch.no_grad():
        lin.weight.fill_(float(rank))
    replicate(mesh, lin)
    out["replicated"] = _np(lin.weight)
    return out


def _task_loader(rank, world, payload):
    """This rank's batches of the sharded loader, as index lists."""
    loader = TLoader(payload["ds"], payload["batch"], shuffle=True, seed=3,
                     process_index=rank, process_count=world)
    return [b[0][:, 0].tolist() for b in loader]


def _port_state(sd, dtype):
    from prifit_torch.models.pointnet2_part_seg_msg import get_model
    from prifit_torch.train.state import create_train_state

    model = get_model(num_parts=PARTS, compute_dtype=dtype,
                      dropout_rate=0.0, device="cpu")
    model.load_state_dict(sd, strict=True)
    return create_train_state(model)


def _eigh_like_jax():
    """Align ``torch.linalg.eigh``'s eigenvector signs with JAX's, as
    ``test_torch_grad.align_eigh_signs`` does (the fit samples along the
    axes, so a flipped column moves the chamfer)."""
    import jax.numpy as jnp

    orig = torch.linalg.eigh

    def eigh(A):
        w, v = orig(A)
        ref = torch.as_tensor(np.array(jnp.linalg.eigh(
            jnp.asarray(A.detach().cpu().numpy()))[1]))
        dots = torch.sum(v * ref, dim=-2)
        return w, v * torch.where(dots < 0, -1.0, 1.0)[..., None, :]

    torch.linalg.eigh = eigh
    return orig


def run_port_steps(payload, group=None, rank=0, world=1):
    """The supervised step on ``x`` and the self-sup step on ``blobs``,
    each from the payload's weights, on this rank's shard; returns the
    losses, averaged gradients, updated parameters and buffers."""
    orig_eigh = _eigh_like_jax() if payload.get("align_eigh") else None
    try:
        return _port_steps(payload, group, rank, world)
    finally:
        if orig_eigh is not None:
            torch.linalg.eigh = orig_eigh


def _port_steps(payload, group, rank, world):
    from prifit_torch.models.pointnet2_part_seg_msg import get_loss
    from prifit_torch.nn.norm import set_process_group
    from prifit_torch.train.steps import make_selfsup_step, \
        make_supervised_step

    b = B // world
    part = slice(rank * b, (rank + 1) * b)
    fdt = torch.float64 if payload.get("double") else torch.float32
    x = torch.from_numpy(payload["x"][part]).to(fdt)
    cls = torch.from_numpy(payload["cls"][part]).to(fdt)
    target = torch.from_numpy(payload["target"][part])
    blobs = torch.from_numpy(payload["blobs"][part]).to(fdt)
    key = BASE if payload["dtype"] == "mxsr" else None
    out = {}
    for name, sd, run in (
            ("sup", payload["sd"], lambda st: make_supervised_step(
                get_loss)(st, x, cls, target, LR, BN_MOMENTUM, sr_key=key)),
            ("ss", payload["ss_sd"], lambda st: make_selfsup_step(
                **SS_KW)(st, blobs, cls, blobs, LR, BN_MOMENTUM, LMBDA,
                         sr_key=key))):
        state = _port_state(sd, payload["dtype"])
        set_process_group(state.model.to(fdt), group)
        state, metrics = run(state)
        out[name] = dict(
            metrics={k: v.item() for k, v in metrics.items()},
            grads={n: _np(p.grad) for n, p in
                   state.model.named_parameters()},
            params={n: _np(p) for n, p in state.model.named_parameters()},
            buffers={n: _np(t) for n, t in state.model.named_buffers()})
    return out


def _task_steps(rank, world, payload):
    return run_port_steps(payload, dist.group.WORLD, rank, world)


def _task_norms(rank, world, payload):
    """A batch norm, an ``mxsr`` SA region and an f32-storage K-max region
    on this rank's half of the payload's inputs: outputs, input
    cotangents (shares: divided by the world size), averaged parameter
    gradients and running statistics."""
    from prifit_torch.nn.mixed import mx_chain
    from prifit_torch.nn.norm import BatchNorm, set_process_group
    from prifit_torch.parallel.collectives import average_gradients, psum

    group = dist.group.WORLD if world > 1 else None
    out = {}

    def shard(a):
        b = a.shape[0] // world
        return torch.from_numpy(a[rank * b:(rank + 1) * b].copy())

    def finish(name, loss, inputs, params):
        loss = psum(loss, group) / world if group is not None else loss
        loss.backward()
        average_gradients(params, group)
        out[name + "_dx"] = [_np(t.grad.float()) / world for t in inputs]
        out[name + "_dp"] = [_np(p.grad) for p in params]

    bn = set_process_group(BatchNorm(8), group).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(payload["scale"]))
    x = shard(payload["x"]).requires_grad_()
    y = bn(x, momentum=0.5)
    out["bn_y"] = _np(y)
    out["bn_stats"] = [_np(bn.running_mean), _np(bn.running_var)]
    finish("bn", (y * shard(payload["gx"])).mean(), [x],
           list(bn.parameters()))

    for name, cfg, pre, key, storage in (
            ("sr", (True, True, True), "pre_bf", BASE, torch.bfloat16),
            ("f32", (False, True, False), "pre", None, torch.float32)):
        params = [torch.nn.Parameter(torch.from_numpy(a.copy()))
                  for a in payload[name + "_params"]]
        pre_bn = (params[0], params[1]) if cfg[0] else None
        rest = params[2:] if cfg[0] else params
        chain = tuple(tuple(rest[i:i + 4]) for i in range(0, len(rest), 4))
        p = shard(payload[pre])
        if storage == torch.bfloat16:
            p = p.bfloat16()
        p.requires_grad_()
        o, stats = mx_chain(cfg, p, (pre_bn, chain), key, storage=storage,
                            group=group)
        out[name + "_y"] = _np(o.float())
        out[name + "_stats"] = [_np(t) for st in stats for t in st]
        finish(name, (o.float() * shard(payload["g_" + name])).mean(), [p],
               params)
    return out



# ------------------------------------------------------------------ tests

def test_collectives_and_mesh_on_two_ranks():
    """Values and stated transposes of psum, all_gather and ppermute, the
    gradient average, and the mesh helpers, on 2 gloo ranks."""
    r0, r1 = spawn_run(2, _task_collectives)
    for r, res in enumerate((r0, r1)):
        # all_gather: the gathered sum is 1 + 2 + 2 + 4; the cotangent of
        # each rank's a is summed over both ranks (2) times its factor
        assert res["gather_val"] == 9.0
        np.testing.assert_array_equal(res["gather_grad"], [2 * (r + 1)] * 2)
        # psum of b^2: 9 + 16; d/db = 2 b summed over both ranks' ones
        assert res["psum_val"] == 25.0
        assert res["psum_grad"] == 2 * (3.0 + r) * 2
        # the ring: rank r gets rank r-1's value; the backward hands the
        # cotangent (r' + 2 of the receiving rank r' = r + 1) back
        assert res["perm_val"] == 10.0 * ((r - 1) % 2 + 1)
        assert res["perm_grad"] == (r + 1) % 2 + 2
        assert res["avg"] == 1.0
        assert res["mesh"] == ({"data": 2}, {"data": r}, 2)
        assert res["data_mesh"] == (1, r == 0, [0])
        assert res["sharding"] == (r, 2)
        np.testing.assert_array_equal(res["shard"][0],
                                      np.arange(8).reshape(4, 2)[2 * r:
                                                                 2 * r + 2])
        np.testing.assert_array_equal(res["shard"][1], [2 * r, 2 * r + 1])
        np.testing.assert_array_equal(res["replicated"], np.zeros((2, 2)))


def _env_rank(rank, world, port, out_dir):
    """A rank started as ``torchrun`` starts one: only the environment
    tells it the group."""
    from prifit_torch.parallel import maybe_initialize_distributed

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    up = maybe_initialize_distributed()
    t = torch.tensor([rank + 1.0])
    dist.all_reduce(t)
    backend = dist.get_backend()
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump((up, t.item(), backend), f)


def test_maybe_initialize_distributed(monkeypatch):
    """One process with no launcher's variables gets False and no group;
    two ranks with torchrun's variables get a gloo group (no CUDA here)
    that sums across them."""
    from prifit_torch.parallel import maybe_initialize_distributed

    for k in ("RANK", "WORLD_SIZE", "PRIFIT_DISTRIBUTED"):
        monkeypatch.delenv(k, raising=False)
    assert maybe_initialize_distributed() is False
    assert not dist.is_initialized()
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(_env_rank, args=(2, _free_port(), out_dir), nprocs=2)
        for r in range(2):
            with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
                assert pickle.load(f) == (True, 3.0, "gloo")


class _IndexDataset:
    """Items ``(index, rng draw)``: what a shard holds, and that the item
    rng is keyed by the global index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get(self, index, rng):
        return (np.array([index]), rng.normal(size=2))


@pytest.mark.parametrize("count", [1, 2, 3])
def test_shard_for_host_and_sharded_loader_match_jax(count):
    """``shard_for_host`` and every process's batches of the sharded
    loader (shuffled, drop_last, two epochs) equal the JAX package's,
    item draws included."""
    from prifit_tpu.data.loader import DataLoader as JLoader
    from prifit_tpu.data.loader import shard_for_host as j_shard

    idx = np.random.default_rng(0).permutation(23)
    ds = _IndexDataset(23)
    for i in range(count):
        np.testing.assert_array_equal(t_shard(idx, i, count),
                                      j_shard(idx, i, count))
        tl = TLoader(ds, 3, shuffle=True, seed=4, process_index=i,
                     process_count=count)
        jl = JLoader(ds, 3, shuffle=True, seed=4, process_index=i,
                     process_count=count)
        assert len(tl) == len(jl)
        for _ in range(2):
            tb, jb = list(tl), list(jl)
            assert len(tb) == len(jb)
            for t, j in zip(tb, jb):
                for a, c in zip(t, j):
                    np.testing.assert_array_equal(a, c)


def test_two_ranks_load_the_global_stream():
    """Two ranks, each loading its round-robin shard in batches of 2,
    together load per step the items of the one-process loader's batch of
    4 (the shared epoch shuffle), over two epochs."""
    ds = _IndexDataset(26)
    ranks = spawn_run(2, _task_loader, {"ds": ds, "batch": 2})
    one = TLoader(ds, 4, shuffle=True, seed=3)
    glob = [b[0][:, 0].tolist() for b in one]
    assert len(ranks[0]) == len(ranks[1]) == len(glob) == 6
    for step, g in enumerate(glob):
        assert sorted(ranks[0][step] + ranks[1][step]) == sorted(g)


def _norm_payload():
    rng = np.random.default_rng(5)
    B_, S, K = 4, 6, 8

    def layer(fi, fo):
        return [rng.normal(size=(fo, fi)).astype(np.float32) / fi ** 0.5,
                rng.normal(size=fo).astype(np.float32) * 0.1,
                rng.uniform(0.5, 1.5, fo).astype(np.float32) * np.where(
                    rng.random(fo) < 0.2, -1, 1).astype(np.float32),
                rng.normal(size=fo).astype(np.float32) * 0.1]

    pre = rng.normal(size=(B_, S, K, 16)).astype(np.float32)
    return dict(
        x=(3 + rng.normal(size=(B_, 5, 8))).astype(np.float32),
        gx=rng.normal(size=(B_, 5, 8)).astype(np.float32),
        scale=rng.uniform(0.5, 1.5, 8).astype(np.float32),
        pre=pre, pre_bf=pre,
        sr_params=[rng.uniform(0.5, 1.5, 16).astype(np.float32),
                   rng.normal(size=16).astype(np.float32) * 0.1]
        + layer(16, 24) + layer(24, 32),
        f32_params=layer(16, 24),
        g_sr=rng.normal(size=(B_, S, 32)).astype(np.float32),
        g_f32=rng.normal(size=(B_, S, 24)).astype(np.float32))


def test_norms_and_regions_on_two_ranks():
    """A batch norm, an ``mxsr`` SA region (pre-BN, two layers, K-max; the
    stochastic rounding's bits at each rank's global offset) and an
    f32-storage K-max region on 2 ranks, each with half the batch,
    against one process on the whole batch: the same outputs and running
    statistics (1e-6 and 1e-5 relative: the moments are summed in another
    order, and a variance of E[x^2] - E[x]^2 loses digits at mean 3),
    input cotangents and averaged parameter gradients within 1e-5 of the
    largest entry (measured: the ``mxsr`` input cotangent bit for bit,
    its gradients 3e-7; with the rounding offsets left at 0 they are 1e-2
    off, a rank-local statistic is off by O(1))."""
    payload = _norm_payload()
    one = _task_norms(0, 1, payload)
    two = spawn_run(2, _task_norms, payload)

    def cat(k):
        a, b = two[0][k], two[1][k]
        if isinstance(a, list):
            return [np.concatenate([u, v]) for u, v in zip(a, b)]
        return np.concatenate([a, b])

    for name in ("bn", "sr", "f32"):
        tol = 1e-5
        np.testing.assert_allclose(cat(name + "_y"), one[name + "_y"],
                                   rtol=1e-6, atol=1e-6, err_msg=name)
        stats = "bn_stats" if name == "bn" else name + "_stats"
        for u, v, w in zip(two[0][stats], two[1][stats], one[stats]):
            np.testing.assert_array_equal(u, v)
            np.testing.assert_allclose(u, w, rtol=1e-5, atol=1e-7)
        for u, v in zip(cat(name + "_dx"), one[name + "_dx"]):
            assert np.abs(u - v).max() <= tol * np.abs(v).max(), name
        for u, v, w in zip(two[0][name + "_dp"], two[1][name + "_dp"],
                           one[name + "_dp"]):
            np.testing.assert_array_equal(u, v)
            assert np.abs(u - w).max() <= tol * np.abs(w).max(), name


def test_rounding_offsets_give_the_global_bits():
    """The stochastic rounding of a shard at its global offset has the
    bits of the whole tensor's rounding: ``sr_bf16`` and the plain K-max
    backward passes (#7, #8), each rank's half against the whole."""
    from prifit_torch.kernels import max_bwd
    from prifit_torch.kernels.stochastic_round import sr_bf16

    rng = np.random.default_rng(9)
    rows, K, F = 12, 4, 16
    x = torch.from_numpy(rng.normal(size=(rows, F)).astype(np.float32))
    whole = sr_bf16(BASE, x).view(torch.int16)
    for r in range(2):
        half = x[r * 6:(r + 1) * 6]
        got = sr_bf16(BASE, half, r * half.numel()).view(torch.int16)
        assert torch.equal(got, whole[r * 6:(r + 1) * 6])
    z = torch.from_numpy(rng.integers(-3, 4, size=(rows * K, F))
                         .astype(np.float32)).bfloat16()
    zsel = z.view(rows, K, F).amax(1)
    g = torch.from_numpy(rng.normal(size=(rows, F)).astype(np.float32))
    out = torch.relu(zsel.float() + 1).bfloat16()
    cnt, gsm = max_bwd.cnt_gsm(z, zsel, g, out, BASE)
    vec = [torch.from_numpy(rng.normal(size=F).astype(np.float32))
           for _ in range(4)]
    dz = max_bwd.dz(z, zsel, gsm, *vec, BASE)
    for r in range(2):
        rs, zs = slice(r * 6, (r + 1) * 6), slice(r * 6 * K, (r + 1) * 6 * K)
        c, gs = max_bwd.cnt_gsm(z[zs], zsel[rs], g[rs], out[rs], BASE,
                                r * 6 * F)
        assert torch.equal(c, cnt[rs])
        assert torch.equal(gs.view(torch.int16), gsm[rs].view(torch.int16))
        d = max_bwd.dz(z[zs], zsel[rs], gs, *vec, BASE, r * 6 * K * F)
        assert torch.equal(d.view(torch.int16), dz[zs].view(torch.int16))


# ------------------------------------------------ the steps against JAX

def _jax_reference(dtype):
    """JAX's supervised and self-sup step on the global batch (f32 or
    mxsr), from one variable set: the gradients, losses, new batch
    statistics, and the parameters after JAX's Adam update; for mxsr also
    on the input scaled by 1 +- 2^-20 (its own spread).  And the port's
    state dicts of the same weights."""
    import jax
    import jax.numpy as jnp

    import prifit_tpu.nn.pointnet2 as jpn2
    from prifit_torch.convert import params_from_jax, state_dict_from_jax
    from prifit_torch.nn.mixed import fold_in
    from prifit_tpu.models import get_module
    from prifit_tpu.train.state import TrainState as JTrainState
    from prifit_tpu.train.state import make_optimizer as j_make_optimizer
    from test_torch_train import XYZ_GAIN, jax_variables

    with pytest.MonkeyPatch.context() as mp_:
        mp_.setenv("PRIFIT_DET_FPS", "1")
        calls = [0]

        def mx_key(mod):
            i = calls[0]
            calls[0] += 1
            return jnp.asarray(fold_in(BASE, i), jnp.uint32)

        mp_.setattr(jpn2, "_mx_key", mx_key)
        rng = np.random.default_rng(21)
        x = rng.normal(size=(B, N, 3)).astype(np.float32)
        cls = np.zeros((B, 16), np.float32)
        cls[:, 2] = 1.0
        target = rng.integers(0, PARTS, size=(B, N))
        lab = np.arange(N) % 3
        blobs = np.stack([np.eye(3)[rng.permutation(lab)] * 4.0
                          + rng.normal(size=(N, 3)) * 0.3
                          for _ in range(B)]).astype(np.float32)
        mod = get_module("pointnet2_part_seg_msg")
        f32_model = mod.get_model(num_parts=PARTS, compute_dtype="f32",
                                  dropout_rate=0.0)
        variables = jax_variables(f32_model, rng, x, cls)
        model = mod.get_model(num_parts=PARTS, compute_dtype=dtype,
                              dropout_rate=0.0)
        ss_params = jax.tree_util.tree_map(np.array, variables["params"])
        ss_params["fp1"]["PointMLP_0"]["w0"][16:22] *= XYZ_GAIN
        rngs = {"sampling": jax.random.PRNGKey(4),
                "dropout": jax.random.PRNGKey(5),
                "selfsup": jax.random.PRNGKey(6)}
        cj = jnp.asarray(cls)

        def both(params, ss_p, stats, xx, bb):
            calls[0] = 0
            out, upd = model.apply(
                {"params": params, "batch_stats": stats}, xx, cj,
                train=True, bn_momentum=BN_MOMENTUM, rngs=rngs,
                mutable=["batch_stats"])
            loss = mod.get_loss(out.seg_logits, jnp.asarray(target))
            calls[0] = 0
            ss, ss_upd = model.apply(
                {"params": ss_p, "batch_stats": stats,
                 "selfsup_state": {"beta": jnp.ones((), jnp.float32)}},
                bb, cj, chamfer_points=bb, train=True,
                bn_momentum=BN_MOMENTUM, rngs=rngs,
                mutable=["batch_stats", "selfsup_state"],
                include_convex_loss=True, **SS_KW)
            ss_loss = jnp.mean(ss.total_loss) * LMBDA
            return loss + ss_loss, (loss, ss_loss, ss.chamfer_loss,
                                    upd["batch_stats"],
                                    ss_upd["batch_stats"])

        fn = jax.jit(jax.value_and_grad(both, argnums=(0, 1), has_aux=True))
        tx = j_make_optimizer("Adam", 1e-4)
        apply = jax.jit(lambda st, g: st.apply_gradients(g, LR))
        runs = []
        scales = (1.0,) if dtype == "f32" else (1.0, 1 + 2.0 ** -20,
                                                1 - 2.0 ** -20)
        for s in scales:
            (_, (loss, ss_loss, cham, stats, ss_stats)), (g, ss_g) = fn(
                variables["params"], ss_params, variables["batch_stats"],
                jnp.asarray(x * np.float32(s)),
                jnp.asarray(blobs * np.float32(s)))
            run = {}
            for name, p, grads, st, m in (
                    ("sup", variables["params"], g, stats,
                     {"loss": float(loss)}),
                    ("ss", ss_params, ss_g, ss_stats,
                     {"ss_loss": float(ss_loss),
                      "chamfer_loss": float(cham)})):
                jst = JTrainState(step=jnp.zeros((), jnp.int32), params=p,
                                  batch_stats=variables["batch_stats"],
                                  selfsup_state={}, opt_state=tx.init(p),
                                  tx=tx)
                new = apply(jst, grads)
                sd = state_dict_from_jax({"params": new.params,
                                          "batch_stats": st})
                run[name] = dict(
                    metrics=m,
                    grads={k: v.numpy() for k, v in
                           params_from_jax(grads).items()},
                    state={k: v.numpy() for k, v in sd.items()})
            runs.append(run)
    payload = dict(
        x=x, cls=cls, target=target, blobs=blobs, dtype=dtype,
        sd=state_dict_from_jax(variables),
        ss_sd=state_dict_from_jax({"params": ss_params,
                                   "batch_stats": variables["batch_stats"]}))
    return runs, payload


def _zero_grad_bias(name):
    from test_torch_train import _zero_grad_bias as zgb

    return zgb(name)


def _rel(g, r):
    return float(np.linalg.norm(g - r) / np.linalg.norm(r))


@pytest.mark.parametrize("dtype", ["f32", "mxsr"])
def test_dp_steps_on_two_ranks_match_jax_global_batch(dtype):
    """One supervised and one self-sup step (1 mean-shift step, 6 slots, a
    cloud of 3 blobs) on 2 gloo ranks, each with half of a batch of 2,
    against JAX's step on the whole batch and the port's one-process step
    on it.  Both ranks end with the same parameters and statistics.

    f32 (the limits of ``test_torch_train.py``): losses within 1e-5
    (sup) and 1e-4 (self-sup, f32 clustering and fit) relative of JAX's;
    each parameter's gradient within 5e-2 of its norm of JAX's (JAX's own
    f32 error) and 2e-2 of its norm of the one-process port step's run in
    float64; the running statistics within 1e-5 of JAX's, absolute and
    relative (the self-sup step's blob clouds give variances near 30).  The float64
    limit is four times ``F64_RTOL`` of ``test_torch_train.py``: at this
    seed one of the 131072 entries after the head's batch norm lies
    7e-6 from 0 in float64 and just below 0 in the two-rank f32 forward
    (the sums run in another order), and that one relu flip moves the
    head's batch-norm backward, and every gradient below it, by 5e-3 to
    7e-3 of their norms (JAX's f32 step is 5e-3 to 9e-3 off there too).
    A missing or doubled reduction is O(1); the exact reductions are held
    tightly by ``test_norms_and_regions_on_two_ranks``.

    mxsr (the limits of ``test_torch_mixed.py``: bf16 storage makes the
    gradient chaotic at this size): losses, gradients and statistics
    within twice JAX's own spread under the input scaled by 1 +- 2^-20,
    plus 1e-6 / 1e-4 relative (losses), 5e-2 of each norm (gradients),
    1e-5 absolute and relative (statistics).  The rounding bits are the global batch's (a
    rank's shard offsets its flat index), so the two-rank step and the
    one-process step draw the same bits.

    Parameters after the Adam update: Adam's first step moves an element
    by lr times ``g / (|g| + 1e-8)`` (``g`` with the coupled weight decay),
    so each differs from JAX's by at most 2 lr, and at f32 by at most 1e-6
    wherever JAX's ``|g|`` is above 5e-2 of the tensor's largest (the
    sign is then not rounding noise)."""
    runs, payload = _jax_reference(dtype)
    payload["align_eigh"] = True
    ranks = spawn_run(2, _task_steps, payload)
    one = run_port_steps({**payload, "double": True}) \
        if dtype == "f32" else None
    ref, spread_runs = runs[0], runs[1:]

    def spread(get):
        return max((float(np.abs(np.asarray(get(r)) - np.asarray(get(ref)))
                          .max()) for r in spread_runs), default=0.0)

    for name in ("sup", "ss"):
        got = ranks[0][name]
        other = ranks[1][name]
        for k in ("params", "buffers"):
            for n, v in got[k].items():
                np.testing.assert_array_equal(v, other[k][n], err_msg=n)
        rtol = 1e-5 if name == "sup" else 1e-4
        for k, v in ref[name]["metrics"].items():
            lim = 2 * spread(lambda r: r[name]["metrics"][k]) \
                + rtol * abs(v)
            assert abs(got["metrics"][k] - v) <= lim, (name, k)
        checked = 0
        for n, r in ref[name]["grads"].items():
            g = got["grads"][n]
            if _zero_grad_bias(n) or not r.any():
                continue
            own = max((_rel(s[name]["grads"][n], r) for s in spread_runs),
                      default=0.0)
            assert _rel(g, r) <= 2 * own + 5e-2, (name, n, _rel(g, r), own)
            if dtype == "f32":
                assert _rel(g, one[name]["grads"][n]) <= 2e-2, (name, n)
            new, jnew = got["params"][n], ref[name]["state"][n]
            assert np.abs(new - jnew).max() <= 2 * LR + 1e-6, (name, n)
            if dtype == "f32":
                g_eff = np.abs(r + 1e-4 * payload[
                    "sd" if name == "sup" else "ss_sd"][n].numpy())
                sure = g_eff > 5e-2 * g_eff.max()
                assert np.abs(new - jnew)[sure].max() <= 1e-6, (name, n)
            checked += 1
        assert checked > 60
        for n, buf in got["buffers"].items():
            if n.endswith(("running_mean", "running_var")):
                lim = 2 * spread(lambda r: r[name]["state"][n]) + 1e-5
                np.testing.assert_allclose(buf, ref[name]["state"][n],
                                           rtol=1e-5, atol=lim,
                                           err_msg=(name, n))


# ------------------------------------------- the contrastive step on 2 ranks

def _contrastive_payload():
    """The port's seeded f32 weights, a gaussian cloud of ``B`` shapes
    with component labels, and the negatives' uniforms ``[B, N, N]`` (the
    draw the step would make), all from a numpy seed.  The shapes have 2
    and 32 components, so their shares of positive pairs (about 1/2 and
    1/32) are far from the batch's."""
    from prifit_torch.entry import init_weights
    from prifit_torch.models.pointnet2_part_seg_msg import get_model

    rng = np.random.default_rng(43)
    x = rng.normal(size=(B, N, 3)).astype(np.float32)
    cls = np.zeros((B, 16), np.float32)
    cls[:, 4] = 1.0
    model = get_model(num_parts=PARTS, compute_dtype="f32",
                      dropout_rate=0.0, device="cpu")
    init_weights(model, torch.Generator().manual_seed(7))
    lab = np.stack([rng.permutation(np.arange(N) % c) for c in (2, 32)])
    return dict(x=x, cls=cls, lab=lab,
                uniforms=rng.random((B, N, N), dtype=np.float32),
                sd=model.state_dict())


def run_contrastive_step(payload, group=None, rank=0, world=1):
    """One contrastive step from the payload's weights on this rank's
    shard (its uniforms too): the loss, the averaged gradients, and the
    parameters and buffers after the update."""
    from prifit_torch.models.pointnet2_part_seg_msg import get_selfsup_loss
    from prifit_torch.nn.norm import set_process_group
    from prifit_torch.train.steps import make_contrastive_step

    part = slice(rank * (B // world), (rank + 1) * (B // world))
    x, cls, lab, u = (torch.from_numpy(payload[k][part]) for k in
                      ("x", "cls", "lab", "uniforms"))
    state = _port_state(payload["sd"], "f32")
    set_process_group(state.model, group)
    state, m = make_contrastive_step(get_selfsup_loss, margin=0.5)(
        state, x, cls, lab, LR, BN_MOMENTUM, LMBDA, uniforms=u)
    return dict(
        loss=m["ss_loss"].item(),
        grads={n: _np(p.grad) for n, p in state.model.named_parameters()},
        params={n: _np(p) for n, p in state.model.named_parameters()},
        buffers={n: _np(t) for n, t in state.model.named_buffers()})


def _task_contrastive(rank, world, payload):
    return run_contrastive_step(payload, dist.group.WORLD, rank, world)


def test_contrastive_step_on_two_ranks_matches_global_batch():
    """The contrastive step (``make_contrastive_step`` with the model's
    group: the share of positive pairs and the loss's mean are the global
    batch's) on 2 gloo ranks, each with one shape of 2 and its slice of
    the fixed uniforms, against the port's one-process step on both
    shapes: the loss within 1e-5 relative, each gradient within 2e-2 of
    its norm (``test_dp_steps_on_two_ranks_match_jax_global_batch``'s
    limit against the one-process step: the ranks sum in another order),
    the running statistics within 1e-5, and every updated parameter
    within 2 lr (Adam's first step moves an element by at most lr).  A
    rank-local share of positive pairs keeps other negatives on each
    rank.  Both ranks end with the same state."""
    payload = _contrastive_payload()
    r0, r1 = spawn_run(2, _task_contrastive, payload)
    one = run_contrastive_step(payload)
    for k in ("params", "buffers"):
        for n, v in r0[k].items():
            np.testing.assert_array_equal(v, r1[k][n], err_msg=n)
    assert r0["loss"] == r1["loss"]
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=1e-5)
    checked = 0
    for n, ref in one["grads"].items():
        if _zero_grad_bias(n) or not ref.any():
            continue
        assert _rel(r0["grads"][n], ref) <= 2e-2, (n, _rel(r0["grads"][n],
                                                           ref))
        assert np.abs(r0["params"][n] - one["params"][n]).max() \
            <= 2 * LR, n
        checked += 1
    assert checked > 60
    for n, buf in r0["buffers"].items():
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf, one["buffers"][n], rtol=1e-5,
                                       atol=1e-5, err_msg=n)
