"""The reference's first three optimizer steps of the trainer's iteration:
supervised, self-sup, supervised.

The model is the frozen copy's (:mod:`benchmark.reference.port.models`),
built as ``prifit_torch/cli/train_partseg.py::build_model`` builds the
configuration's model, with the benchmark's weights from the seed; the
steps are those of ``prifit_torch/train/steps.py`` written out plainly
(Adam with coupled weight decay through ``torch.optim.Adam``, a zero
gradient for a leaf the loss does not reach); the batches come from the
tree's files (:mod:`benchmark.reference.batches`); the steps' draws come
from a generator on the device seeded as the trainer seeds epoch 0's.
TF32 is off throughout.

``mode``: ``"sound"``; ``"lower"``, the control (the encoder and the
convex loss one precision below the configuration's,
:mod:`benchmark.reference.precision`); ``"half_batch"``, a fault (each
step takes the first half of its batch only, its loss the mean over it).
The convex self-sup step keeps what its convex branch took and gave
(:mod:`benchmark.reference.convex`); given the program's, the reference
judges them stage by stage.
"""

import contextlib

import torch

from benchmark import weights
from benchmark.reference import convex
from benchmark.reference.batches import first_batches
from benchmark.reference.port.models import dgcnn as dgcnn_mod
from benchmark.reference.port.models import pointnet2_part_seg_msg as msg_mod
from benchmark.reference.precision import lower_convex, lower_precision

MODELS = {"pointnet2_part_seg_msg": msg_mod, "dgcnn": dgcnn_mod}
BETA1 = 0.9


def build_model(p: dict, device):
    """The configuration's model of the frozen copy, on ``device``."""
    if p["model"] == "dgcnn":
        return dgcnn_mod.get_model(num_parts=p["num_parts"],
                                   nn_nb=p["dgcnn_k"], device=device)
    if p["model"] == "pointnet2_part_seg_msg":
        return msg_mod.get_model(num_parts=p["num_parts"],
                                 compute_dtype=p["encoder_dtype"],
                                 device=device)
    raise ValueError(f"no reference for {p['model']}")


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def convex_kwargs(p: dict) -> dict:
    """The self-sup step's convex-loss arguments, as ``build_steps`` gives
    them for the recipe (no entropy, intersection, pruning or cuboids)."""
    return dict(include_convex_loss=True, if_cuboid=False,
                include_intersect_loss=False, include_entropy_loss=False,
                include_pruning=False, quantile=p["quantile"],
                msc_iterations=p["msc_iterations"],
                max_num_clusters=p["max_num_clusters"],
                num_bandwidth_candidates=p["num_bandwidth_candidates"],
                n_per_prim=p["n_per_prim"], alpha=p["alpha"])


def _half(x, half: bool):
    return x[:x.shape[0] // 2] if half else x


def _opt_grads(model, opt, wd):
    """Each leaf's gradient as Adam takes it (coupled decay added)."""
    return [(p.grad + wd * p.detach()).norm() for p in model.parameters()]


def readings(p: dict, seed: int, tree: dict, device, mode: str = "sound",
             encoder_modules=(), control_precision: str | None = None,
             judge: dict | None = None) -> dict:
    """The readings the program's set-up keeps, worked out by the
    reference; also each step's gradient norm a leaf (``step_grads``),
    for the rule that leaves out leaves the reference does not move.
    ``judge``: the program's convex branch of the self-sup step
    (:func:`benchmark.reference.convex.to_cpu`), judged against the
    batch the reference worked out (``judged``)."""
    device = torch.device(device)
    half = mode == "half_batch"
    sups, sss = first_batches(p, seed, tree, n_sup=2, n_ss=1)

    def dev(batch):
        return tuple(_half(torch.as_tensor(a, device=device), half)
                     for a in batch)

    model = build_model(p, device)
    model.load_state_dict(weights.state_dict(
        lambda d: build_model(p, d), seed, device), strict=True)
    mod = MODELS[p["model"]]
    wd = p["decay_rate"]
    # epoch 0 of the trainer's schedules
    lr = max(p["learning_rate"], p["lr_clip"])
    momentum = max(0.1 * 0.5 ** (0 // p["step_size"]), 0.01)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8, weight_decay=wd)
    gen = torch.Generator(device=device).manual_seed(seed * 1000003 + 0)
    names = [n for n, _ in model.named_parameters()]
    w0 = [q.detach().clone() for q in model.parameters()]
    lower = contextlib.nullcontext()
    if mode == "lower":
        lower = contextlib.ExitStack()
        lower.enter_context(lower_precision(model, encoder_modules,
                                            control_precision))
        lower.enter_context(lower_convex(mod))

    def update(loss):
        # a loss with no gradient (no cluster to fit) takes the update
        # with zero gradients, as the program's step does
        if loss.requires_grad:
            loss.backward()
        for q in model.parameters():
            if q.grad is None:
                q.grad = torch.zeros_like(q)
        g = _opt_grads(model, opt, wd)
        opt.step()
        return torch.stack(g)

    def sup(batch):
        points, cls, target = dev(batch)
        model.train()
        opt.zero_grad(set_to_none=True)
        out = model(points, cls, bn_momentum=momentum, generator=gen)
        loss = mod.get_loss(out.seg_logits, target)
        return loss.detach(), update(loss)

    def ss(batch):
        points, cls, third = dev(batch)
        model.train()
        opt.zero_grad(set_to_none=True)
        if p["ss_loss"] == "contrastive":
            out = model(points, cls, bn_momentum=momentum, generator=gen)
            loss = mod.get_selfsup_loss(out.feat, third, gen,
                                        p["margin"]) * p["lmbda"]
        else:
            hook, seen = convex.capture(model, keep_grad=True)
            out = model(points, cls, chamfer_points=third,
                        bn_momentum=momentum, generator=gen,
                        **convex_kwargs(p))
            hook.remove()
            loss = torch.mean(out.total_loss) * p["lmbda"]
            step = loss.detach(), update(loss)
            kept.append(convex.to_cpu(seen[0]))
            return step
        return loss.detach(), update(loss)

    kept = []
    with no_tf32(), lower:
        l1, g1 = sup(sups[0])
        grad = torch.stack([(opt.state[q]["exp_avg"] / (1 - BETA1)).norm()
                            for q in model.parameters()])
        l2, g2 = ss(sss[0])
        l3, g3 = sup(sups[1])
    change = torch.stack([(q.detach() - w).norm()
                          for q, w in zip(model.parameters(), w0)])
    out = {"loss": torch.stack([l1, l2, l3]).tolist(),
           "ss": kept[0] if kept else None, "judged": None,
           "grad_norm": dict(zip(names, grad.tolist())),
           "change_norm": dict(zip(names, change.tolist())),
           "step_grads": [dict(zip(names, g.tolist())) for g in (g1, g2, g3)]}
    del model, opt, w0
    if judge is not None:
        B = judge["emb"].shape[0]
        with no_tf32():
            out["judged"] = convex.judge(p, sss[0][0][:B], sss[0][2][:B],
                                         judge, device, p["lmbda"])
    return out

