# Frozen copy of prifit_torch/models/dgcnn.py at commit 0adee2a, for the
# benchmark's reference; see benchmark/reference/__init__.py.
"""DGCNN part segmentation, the alternative PRIFIT encoder.

Port of ``prifit_tpu/models/dgcnn.py::get_model`` (reference
``src/dgcnn.py:225-267``, selected with ``'dgcnn' in args.model`` and
built as ``DGCNGn(emb_size=128, nn_nb=args.dgcnn_k)``): the per-point
embedding and segmentation logits of :class:`prifit_torch.nn.dgcnn.
DGCNNGn` (under ``dgcnn.``), with the convex self-sup loss computed
inside the forward on the embedding, as the MSG model does.  ``feat``
is the embedding.

The entropy weight of the convex loss stays at 1.0: the JAX model keeps
no ``selfsup_state`` and passes no ``beta``, so unlike the MSG model's it
never decays.  The convex loss takes its draws (entropy subsample,
jitter) from ``generator`` in training only; an eval forward takes its
deterministic fallbacks.  The encoder has no batch norm, so
``bn_momentum`` is taken and unused.
"""

import torch
from torch import nn

from benchmark.reference.port.geometry.convex_loss import convex_loss
from benchmark.reference.port.models.common import (
    SegOutput,
    nll_loss,
    pairwise_contrastive_loss,
)
from benchmark.reference.port.nn.dgcnn import DGCNNGn
from benchmark.reference.port.utils.device import resolve_device


class get_model(nn.Module):
    def __init__(self, num_parts: int = 3, nn_nb: int = 80,
                 normal_channel: bool = False, device=None):
        """A 128-d embedding over a ``nn_nb``-neighbour graph.
        ``device``: where the parameters live; CUDA unless the caller
        names another (raises without a GPU)."""
        super().__init__()
        self.dgcnn = DGCNNGn(128, 6 if normal_channel else 3, nn_nb,
                             num_seg=num_parts)
        # data parallelism: the convex loss's group (group norms need none)
        self.process_group = None
        self.to(resolve_device(device))

    def forward(self, xyz: torch.Tensor, cls_label=None,
                chamfer_points: torch.Tensor | None = None, *,
                bn_momentum: float = 0.1,
                include_convex_loss: bool = False,
                if_cuboid: bool = False,
                include_intersect_loss: bool = False,
                include_entropy_loss: bool = False,
                include_pruning: bool = False,
                quantile: float = 0.01, msc_iterations: int = 5,
                max_num_clusters: int = 25, n_per_prim: int = 400,
                num_bandwidth_candidates: int = 2, alpha: float = 1.0,
                evaluation: bool = False,
                generator: torch.Generator | None = None, sr_key=None,
                entropy_sub=None, jitter=None) -> SegOutput:
        """``xyz [B, N, 3(+3)]``; ``cls_label`` is taken for the models'
        common call and unused, as are ``bn_momentum`` and ``sr_key``."""
        embedding, seg = self.dgcnn(xyz)
        zero = torch.zeros((), dtype=torch.float32, device=xyz.device)
        total_loss, chamfer, convex_out = zero, zero, None
        if include_convex_loss:
            draws = dict(generator=generator, entropy_sub=entropy_sub,
                         jitter=jitter) if self.training else {}
            convex_out = convex_loss(
                xyz[..., :3], chamfer_points, embedding, quantile=quantile,
                iterations=msc_iterations,
                max_num_clusters=max_num_clusters, n_per_prim=n_per_prim,
                num_bandwidth_candidates=num_bandwidth_candidates,
                include_intersect_loss=include_intersect_loss,
                include_entropy_loss=include_entropy_loss,
                include_pruning=include_pruning, alpha=alpha,
                if_cuboid=if_cuboid, evaluation=evaluation,
                group=self.process_group, **draws)
            total_loss, chamfer = convex_out.total, convex_out.chamfer
        return SegOutput(seg_logits=torch.log_softmax(seg, dim=-1),
                         hidden=None, feat=embedding, total_loss=total_loss,
                         chamfer_loss=chamfer, convex=convex_out)


def get_loss(pred, target, trans_feat=None):
    """NLL over log-probabilities."""
    return nll_loss(pred, target)


def get_selfsup_loss(feat, target, generator=None, margin=0.5,
                     uniforms=None, group=None):
    """The ACD pairwise contrastive loss
    (:func:`prifit_torch.models.common.pairwise_contrastive_loss`)."""
    return pairwise_contrastive_loss(feat, target, generator, margin,
                                     uniforms=uniforms, group=group)
