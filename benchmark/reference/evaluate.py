"""The reference's eval forward with primitive fit on the cell's test
batches: the frozen copy's model (:mod:`benchmark.reference.train`'s
``build_model``) in eval mode with the benchmark's weights, the convex
loss against the input cloud itself, TF32 off.  ``mode`` ``"lower"`` is
the control (:mod:`benchmark.reference.precision`).  The program's
convex branch is judged stage by stage (:mod:`benchmark.reference.
convex`)."""

import contextlib
import itertools

import numpy as np
import torch

from benchmark import weights
from benchmark.reference.port.data.loader import DataLoader
from benchmark.reference.port.data.shapenet import PartNormalDataset
from benchmark.reference import convex
from benchmark.reference.precision import lower_convex, lower_precision
from benchmark.reference.train import MODELS, build_model, no_tf32


def fit_kwargs(p: dict) -> dict:
    return dict(quantile=p["quantile"], msc_iterations=p["msc_iterations"],
                max_num_clusters=p["max_num_clusters"],
                n_per_prim=p["n_per_prim"],
                num_bandwidth_candidates=p["num_bandwidth_candidates"])


def test_batches(p: dict, seed: int, tree: dict, n: int | None = None):
    """The first ``n`` (all, when None) full batches of the test split,
    in order, as numpy ``(points, cls, seg)``."""
    ds = PartNormalDataset(tree["shapenet"], npoints=p["npoint"],
                           split=p["split"], normal_channel=False,
                           rng=np.random.default_rng(seed))
    loader = DataLoader(ds, batch_size=p["batch_size"], shuffle=False,
                        drop_last=True, seed=seed)
    return list(itertools.islice(iter(loader), n))


def outputs(p: dict, seed: int, tree: dict, device, batch_ids,
            mode: str = "sound", encoder_modules=(),
            control_precision: str | None = None) -> dict:
    """``{batch id: (log-probs [B, N, parts], convex branch)}`` of the
    batches ``batch_ids``, on the CPU (the branch as
    :func:`benchmark.reference.convex.to_cpu` keeps it)."""
    device = torch.device(device)
    batches = test_batches(p, seed, tree)
    model = build_model(p, device)
    model.load_state_dict(weights.state_dict(
        lambda d: build_model(p, d), seed, device), strict=True)
    model.eval()
    lower = contextlib.nullcontext()
    if mode == "lower":
        lower = contextlib.ExitStack()
        lower.enter_context(lower_precision(model, encoder_modules,
                                            control_precision))
        lower.enter_context(lower_convex(MODELS[p["model"]]))
    out = {}
    hook, seen = convex.capture(model, keep_grad=False)
    with no_tf32(), lower, torch.no_grad():
        for i in sorted(set(batch_ids)):
            points = torch.as_tensor(batches[i][0], device=device)
            cls = torch.zeros((points.shape[0], p["num_classes"]),
                              dtype=torch.float32, device=device)
            o = model(points, cls, chamfer_points=points,
                      include_convex_loss=True, **fit_kwargs(p))
            out[i] = (o.seg_logits.cpu(), convex.to_cpu(seen.pop()))
    hook.remove()
    del model
    return out


def judged(p: dict, seed: int, tree: dict, device, kept) -> dict:
    """``{position in kept: (log-probs, embedding, judged)}``: for each of
    the program's ``kept`` outputs ``(batch id, log-probs, convex
    branch)``, the reference's log-probs and embedding of the batch and
    its judgement of the program's convex branch."""
    batches = test_batches(p, seed, tree)
    ref = outputs(p, seed, tree, device, [b for b, _, _ in kept])
    out = {}
    with no_tf32():
        for k, (b, _, got) in enumerate(kept):
            points = batches[b][0]
            out[k] = (ref[b][0], ref[b][1]["emb"],
                      convex.judge(p, points, points, got, device))
    return out
