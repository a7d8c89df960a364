"""The numbers the correctness check compares, each a gap between the
program's reading and the reference's.  A run compares those its
workload file gives a limit; the others are readings only.

Training (the first three optimizer steps: supervised, self-sup,
supervised):

- ``first_loss_gap``: the first step's ``|L_prog - L_ref| / |L_ref|``;
- ``ss_loss_gap``: the self-sup step's, each side from its own
  embedding (compared for the contrastive loss and for DGCNN, whose
  embeddings agree to rounding; MSG's ``mxsr`` rounding tips a few
  shapes' clusters, which moves this by up to tens of percent);
- ``grad_norm_gap``: over the leaves, the largest gap between the norms
  of the first gradient as Adam got it, ``| |g_prog| - |g_ref| |``, over
  the larger of the reference leaf's norm and the median leaf's;
- ``change_norm_gap``: the same gap of each leaf's change after the three
  steps, at the median leaf, over the leaves the reference moves: a leaf
  whose reference gradient is under a thousandth of the median leaf's in
  every one of the three steps moves under Adam by round-off alone, and
  is left out;
- the convex self-sup step, stage by stage (:mod:`benchmark.reference.
  convex`), ``ss_`` and: ``emb_gap``, the worst shape's
  ``|E_prog - E_ref| / |E_ref|`` of the embedding it clustered;
  ``bandwidth_gap``, the worst shape's relative gap between the
  program's bandwidth and the nearest of the reference's candidates
  (``bandwidth_gap_med`` the median shape's); ``mode_gap``, the largest
  distance, over the shape's bandwidth, from one of the program's
  centres to the nearest of the reference's modes (``mode_gap_med`` the
  median shape's largest);
  ``count_gap``, the relative gap between the program's number of
  clusters over the batch and the reference's, which clusters the
  program's embedding itself; ``weight_gap``, the largest gap of a
  membership; ``fit_gap``, the worst shape's :func:`shape_gap` between
  the program's primitives and the reference's fit of the program's
  memberships; ``chamfer_gap``, the relative gap between the program's
  convex loss and the chamfer of its primitives; ``grad_gap``,
  ``|g_prog - g_ref| / |g_ref|`` of the gradient that reaches the
  embedding, over the shapes of two clusters or more whose primitives,
  when the reference clusters and fits the program's embedding, lie
  within ``ALIKE`` of the program's (a one-cluster shape's memberships
  are all 1, and its true gradient is 0).  ``cluster_share``, the share
  of shapes whose primitives lie more than ``ALIKE`` apart, is a
  reading: near-ties between modes tip up to half of the eval's shapes.
  Which of these a cell compares, its workload file says; PERF.md gives
  the readings behind each choice.

Eval (the sampled outputs of the window): ``logprob_gap``, the largest
``|log p_prog - log p_ref|`` of any point and part, and the convex
branch's numbers as above (but ``grad_gap``), over every sampled shape.
"""

import statistics

import torch

from benchmark.reference.convex import primitives  # noqa: F401

# a leaf whose reference gradient is under this share of the median
# leaf's in every step is left out of the change
STILL = 1e-3
# a shape whose primitives from the reference's clustering of the
# program's embedding lie within this of the program's is clustered alike
ALIKE = 1e-3
# the width of one primitive's row (:func:`primitives`)
ROW = 9


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def norm_gap(prog: dict, ref: dict, names) -> float:
    names = list(names)
    if not names:
        return 0.0
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
               for n in names)


def moved_leaves(ref: dict):
    out = []
    for n in ref["change_norm"]:
        for g in ref["step_grads"]:
            if g[n] >= STILL * statistics.median(g.values()):
                out.append(n)
                break
    return out


def shape_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """One shape's gap between the program's primitives ``a`` and the
    reference's ``b`` (``[K, ROW]`` rows, zero where a slot is invalid),
    as sets: the slots' order follows the NMS's representative ids, which
    a rounding tie between two modes can swap, so each reference
    primitive, the largest first, is matched to the nearest unmatched
    program primitive; the gap is the norm of the matched differences
    over the norm of the reference's.  A different number of primitives
    is a different answer: 1."""
    av = a[a.abs().sum(-1) > 0]
    bv = b[b.abs().sum(-1) > 0]
    if len(av) != len(bv):
        return 1.0
    if not len(bv):
        return 0.0
    d = torch.cdist(bv.double(), av.double())
    free = torch.ones(len(av), dtype=torch.bool)
    sq = 0.0
    for i in torch.argsort(-bv.norm(dim=-1)).tolist():
        j = int(torch.where(free, d[i], torch.inf).argmin())
        free[j] = False
        sq += float(d[i, j]) ** 2
    return sq ** 0.5 / max(float(bv.double().norm()), 1e-30)


def shape_gaps(prog, ref) -> list:
    """:func:`shape_gap` of each shape of two ``[B, ROW K]`` row sets."""
    a = torch.as_tensor(prog).reshape(len(prog), -1, ROW)
    b = torch.as_tensor(ref).reshape(len(ref), -1, ROW)
    return [shape_gap(x, y) for x, y in zip(a, b)]


def _shape_rel(a: torch.Tensor, b: torch.Tensor) -> list:
    """Each shape's ``|a - b| / |b|`` of two ``[B, ...]`` tensors."""
    d = (a.double() - b.double()).flatten(1).norm(dim=1)
    n = b.double().flatten(1).norm(dim=1).clamp_min(1e-30)
    return (d / n).tolist()


def convex_readings(got: dict, judged: dict, ref_emb) -> dict:
    """Per shape, the readings behind the convex branch's numbers: the
    program's outputs ``got`` and the reference's ``judged`` of one batch
    (:mod:`benchmark.reference.convex`), and the reference's own
    embedding of the batch."""
    bw = got["bandwidth"].double()[:, None]
    cands = judged["bw_cands"].double()
    out = {"emb": _shape_rel(got["emb"], ref_emb),
           "bandwidth": ((bw - cands).abs() / cands).amin(-1).tolist(),
           "mode": judged["mode_dist"].tolist(),
           "slots": got["slots"].sum(-1).tolist(),
           "own_slots": judged["own_counts"].tolist(),
           "cluster": shape_gaps(got["rows"], judged["own"]),
           "weight": (got["weights"].double() - judged["weights"].double())
           .abs().flatten(1).amax(-1).tolist(),
           "fit": shape_gaps(got["rows"], judged["fit"]),
           "chamfer": _rel(got["loss"], judged["chamfer"])}
    if judged["grad"] is not None:
        flat = got["grad"].double().flatten(1), \
            judged["grad"].double().flatten(1)
        out["grad_prog"] = flat[0].norm(dim=1).tolist()
        out["grad_ref"] = flat[1].norm(dim=1).tolist()
        out["grad_diff"] = (flat[0] - flat[1]).norm(dim=1).tolist()
    return out


def convex_gaps(readings: list) -> dict:
    """The convex branch's numbers over the batches' :func:`
    convex_readings`."""
    def every(key):
        return [g for r in readings for g in r[key]]

    cluster = every("cluster")
    n_ref = sum(every("own_slots"))
    out = {"emb_gap": max(every("emb")),
           "bandwidth_gap": max(every("bandwidth")),
           "bandwidth_gap_med": statistics.median(every("bandwidth")),
           "mode_gap": max(every("mode")),
           "mode_gap_med": statistics.median(every("mode")),
           "count_gap": abs(sum(every("slots")) - n_ref) / max(n_ref, 1),
           "weight_gap": max(every("weight")),
           "fit_gap": max(every("fit")),
           "chamfer_gap": max(r["chamfer"] for r in readings),
           "cluster_share": sum(g > ALIKE for g in cluster) / len(cluster)}
    if all("grad_ref" in r for r in readings):
        diff = ref = 0.0
        for r in readings:
            for g, n, d, gr in zip(r["cluster"], r["slots"], r["grad_diff"],
                                   r["grad_ref"]):
                if g <= ALIKE and n >= 2:
                    diff, ref = diff + d * d, ref + gr * gr
        out["grad_gap"] = 0.0 if diff == 0.0 else \
            diff ** 0.5 / max(ref ** 0.5, 1e-30)
    return out


def _ref_emb(prog: dict, ref: dict):
    """The reference's embedding of the shapes the program's self-sup
    step took (the first half of them under the half-batch fault)."""
    return ref["ss"]["emb"][:len(prog["ss"]["emb"])]


def training_gaps(prog: dict, ref: dict) -> dict:
    moved = moved_leaves(ref)
    med = statistics.median(ref["change_norm"][n] for n in moved)
    out = {"first_loss_gap": _rel(prog["loss"][0], ref["loss"][0]),
           "ss_loss_gap": _rel(prog["loss"][1], ref["loss"][1]),
           "grad_norm_gap": norm_gap(prog["grad_norm"], ref["grad_norm"],
                                     ref["grad_norm"]),
           "change_norm_gap": statistics.median(
               abs(prog["change_norm"][n] - ref["change_norm"][n])
               / max(ref["change_norm"][n], med, 1e-30) for n in moved)}
    if ref.get("judged") is not None:
        r = convex_readings(prog["ss"], ref["judged"], _ref_emb(prog, ref))
        out.update({"ss_" + k: v for k, v in convex_gaps([r]).items()})
    return out


def eval_gaps(prog: list, ref: dict) -> dict:
    """``prog``: ``[(batch id, log-probs, convex outputs)]``; ``ref``:
    ``{position in prog: (log-probs, reference's embedding, judged)}``."""
    lp = max(float((logp - ref[k][0]).abs().max())
             for k, (_, logp, _) in enumerate(prog))
    readings = [convex_readings(got, ref[k][2], ref[k][1])
                for k, (_, _, got) in enumerate(prog)]
    return {"logprob_gap": lp, **convex_gaps(readings)}


def _worst(prog: dict, ref: dict, key: str, names, top: int) -> dict:
    med = statistics.median(ref[key][n] for n in names)
    gaps = sorted(((abs(prog[key][n] - ref[key][n])
                    / max(ref[key][n], med, 1e-30), n) for n in names),
                  reverse=True)
    return {"median": med, "median_gap": gaps[len(gaps) // 2][0],
            "worst": [[n, g, prog[key][n], ref[key][n]]
                      for g, n in gaps[:top]]}


def training_detail(prog: dict, ref: dict, top: int = 4) -> dict:
    """The readings behind :func:`training_gaps`: each step's losses, the
    convex branch's per-shape readings, and the ``top`` leaves of each
    leaf gap with the program's and the reference's norms."""
    out = {"loss_prog": prog["loss"], "loss_ref": ref["loss"]}
    if ref.get("judged") is not None:
        out["ss"] = convex_readings(prog["ss"], ref["judged"],
                                    _ref_emb(prog, ref))
    moved = moved_leaves(ref)
    out["grad_norm"] = _worst(prog, ref, "grad_norm", list(ref["grad_norm"]),
                              top)
    out["change_norm"] = _worst(prog, ref, "change_norm", moved, top)
    return out
