"""The convex branch (clustering, fit, sampling, chamfer and the backward
to the embedding), judged stage by stage from what the program produced.

The clustering of an embedding is chaotic where two modes nearly tie: a
last-bit difference between the program's mean-shift kernels and the
plain step tips a shape's clusters.  So the reference follows the
program from its own embedding of the batch (the start, judged by
itself against the reference's embedding of the same batch) and judges
each stage from the program's output of the stage before it:

- the bandwidth: the reference's candidates from the program's
  embedding; the program's must be one of them;
- mean-shift: the reference's modes of the program's embedding at the
  program's bandwidth; each of the program's centres must lie on one;
- NMS: the reference clusters the program's embedding itself; the
  number of clusters over the batch, and each shape's primitives;
- membership: the reference's memberships of the program's embedding
  to the program's centres, against the program's;
- the fit: the reference fits the program's memberships; per shape;
- sampling and chamfer: the reference samples the program's primitives
  and takes their chamfer against the batch's chamfer points; against
  the loss the program reported;
- the backward: the reference's gradient of its convex loss to the
  program's embedding, against the program's, on the shapes whose
  clusters came out alike.
"""

import torch

from benchmark.reference.port.clustering.mean_shift import \
    bandwidth_candidates, mean_shift_iterations, membership
from benchmark.reference.port.geometry.convex_loss import convex_loss
from benchmark.reference.port.geometry.fitting import PrimitiveParams, \
    fit_ellipsoids_batch
from benchmark.reference.port.geometry.losses import analytic_chamfer
from benchmark.reference.port.geometry.sampling import \
    sample_primitives_batch


def primitives(params) -> torch.Tensor:
    """Each shape's fitted primitives as one row ``[B, 9 K]`` on the CPU:
    each slot's centre and the upper triangle of ``V diag(r) V^T`` (its
    axes scaled by their half-lengths, free of the solver's signs), zero
    in the invalid slots."""
    v = params.valid[..., None].to(params.r.dtype)
    S = params.V @ torch.diag_embed(params.r) @ params.V.transpose(-1, -2)
    i, j = torch.triu_indices(3, 3)
    flat = torch.cat([params.center, S[..., i, j]], dim=-1) * v
    return flat.reshape(flat.shape[0], -1).detach().cpu()


def branch(out, keep_grad: bool = False) -> dict | None:
    """What a model output's convex branch took and gave: the embedding
    it clustered, the memberships and valid slots, the primitives, the
    loss and, with ``keep_grad``, the gradient that reaches the embedding
    in the backward (zero where none reaches it); on the device, until
    :func:`to_cpu`.  None where the forward ran no convex loss."""
    c = out.convex
    if c is None:
        return None
    emb = out.embedding if out.embedding is not None else out.feat
    got = {"emb": emb.detach(), "weights": c.clusters.weights.detach(),
           "slots": c.clusters.valid, "centers": c.clusters.centers.detach(),
           "bandwidth": c.clusters.bandwidth.detach(),
           "params": PrimitiveParams(*(t.detach() for t in c.params)),
           "loss": c.total.detach(),
           "grad": torch.zeros_like(emb.detach()) if keep_grad else None}
    if keep_grad and emb.requires_grad:
        emb.register_hook(lambda g: got.__setitem__("grad", g.detach()))
    return got


def capture(model, keep_grad: bool):
    """A forward hook on ``model`` that keeps the :func:`branch` of each
    forward.  Returns ``(hook handle, list of branches)``."""
    seen = []
    handle = model.register_forward_hook(
        lambda _m, _a, out: seen.append(branch(out, keep_grad)))
    return handle, seen


def to_cpu(got: dict | None) -> dict | None:
    if got is None:
        return None
    out = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
           for k, v in got.items() if k != "params"}
    out["params"] = PrimitiveParams(*(t.cpu() for t in got["params"]))
    out["rows"] = primitives(got["params"])
    out["loss"] = float(got["loss"])
    return out


def _unit(X):
    return X / torch.clamp_min(torch.linalg.norm(X, dim=-1, keepdim=True),
                               1e-12)


def judge(p: dict, points, chamfer_points, got: dict, device,
          lmbda: float = 1.0) -> dict:
    """The reference's stages from the program's outputs ``got``
    (:func:`to_cpu`'s) of one batch: ``points [B, N, 3]`` the fit's
    targets and ``chamfer_points [B, M, 3]`` the chamfer's, as the
    reference worked them out.  ``lmbda`` scales the loss whose gradient
    the step takes.  Returns, on the CPU: the bandwidth candidates of the
    program's embedding (``bw_cands [B, C]``); each shape's largest
    distance, over its bandwidth, from one of the program's centres to
    the nearest of the reference's modes at the program's bandwidth
    (``mode_dist``); the rows and counts of the reference's own
    clustering and fit of the program's embedding (``own``,
    ``own_counts``); its memberships to the program's centres
    (``weights``); the rows of its fit of the program's memberships
    (``fit``); the chamfer of the program's primitives (``chamfer``);
    and the gradient to the embedding (``grad``, where the program kept
    one)."""
    dev = torch.device(device)
    points = torch.as_tensor(points, device=dev)[..., :3]
    chamfer_points = torch.as_tensor(chamfer_points, device=dev)
    X = got["emb"].to(dev).float().requires_grad_(got["grad"] is not None)
    with torch.enable_grad():
        out = convex_loss(points, chamfer_points, X, quantile=p["quantile"],
                          iterations=p["msc_iterations"],
                          max_num_clusters=p["max_num_clusters"],
                          n_per_prim=p["n_per_prim"],
                          num_bandwidth_candidates=p[
                              "num_bandwidth_candidates"])
        grad = None
        if X.requires_grad:
            loss = out.total * lmbda
            grad = torch.autograd.grad(loss, X, allow_unused=True)[0] \
                if loss.requires_grad else None
            grad = torch.zeros_like(X) if grad is None else grad
    with torch.no_grad():
        # convex_loss normalizes the embedding, cluster_batch again
        Xn = _unit(_unit(X.detach()))
        bw = got["bandwidth"].to(dev)
        cands = torch.stack([
            bandwidth_candidates(Xn, p["quantile"] * 2 ** c, 1)[:, 0]
            for c in range(p["num_bandwidth_candidates"])], dim=-1)
        modes = mean_shift_iterations(Xn, bw, p["msc_iterations"])
        centers = got["centers"].to(dev)
        slots = got["slots"].to(dev)
        dist = torch.cdist(centers, modes,
                           compute_mode="donot_use_mm_for_euclid_dist")
        near = dist.amin(-1) / bw[:, None]
        mode_dist = torch.where(slots, near, 0.0).amax(-1)
        weights = membership(centers, slots, Xn, bw).transpose(1, 2)
        fit = fit_ellipsoids_batch(points, got["weights"].to(dev), slots)
        prog = PrimitiveParams(*(t.to(dev) for t in got["params"]))
        samples, w = sample_primitives_batch(prog, p["n_per_prim"])
        cham = analytic_chamfer(prog, samples, w, chamfer_points)
    return {"bw_cands": cands.cpu(), "mode_dist": mode_dist.cpu(),
            "own": primitives(out.params),
            "own_counts": out.clusters.num_clusters.cpu(),
            "weights": weights.cpu(), "fit": primitives(fit),
            "chamfer": float(cham),
            "grad": None if grad is None else grad.detach().cpu()}
