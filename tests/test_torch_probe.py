"""The port's embedding probe (``prifit_torch/tools/probe_embedding.py``)
against the JAX side's, on the CPU.

The JAX repository's ``tools/probe_embedding.py`` inits
``pointnet2_part_seg_msg`` with flax from a seed, embeds shapes of the
synthetic lift tree, clusters them with the JAX package's
``cluster_batch`` (10 iterations, 25 slots) and scores the clusters
against the true parts with scikit-learn's NMI.  That computation runs
here with the same init and data; the port's ``probe`` takes the same
weights (carried by ``prifit_torch/convert.py``) and must give equal
cluster counts a shape and NMI within 1e-4 (NMI does not depend on the
order of the slots).

Both sides use the f32 encoder: at the default dtype the eval forward
stores bf16 activations, and the two sides' embeddings differ by 3e-3 of
the largest entry.  At f32 they agree to 1e-6 of it but for a few points
that coincide with an sa1 centroid, where FP1's inverse-distance weight
of a zero distance (1e8) meets each side's own rounding of that distance
(up to 4e-5).  Mean shift on random-init embeddings is chaotic at that
level: JAX's own counts change under noise of 3e-5, and at most
quantiles a point or a cluster flips between the two forwards.  So the
test holds the two parts apart: the port's forward within 1e-4 of the
largest entry of JAX's embedding, and the port's clustering and NMI,
given JAX's embedding of each batch in place of its own, equal to
JAX's: the same cluster counts a shape (2 to 4 at the quantile 0.04) and
NMI within 1e-12.
"""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import normalized_mutual_info_score

from prifit_torch.clustering.mean_shift import cluster_batch
from prifit_torch.convert import state_dict_from_jax
from prifit_torch.data.shapenet import PartNormalDataset as TDataset
from prifit_torch.models.pointnet2_part_seg_msg import get_model
from prifit_torch.tools import probe_embedding as T
from prifit_torch.tools.synthetic_primitive_dataset import \
    make_lift_benchmark
from prifit_tpu.clustering.mean_shift import cluster_batch as j_cluster
from prifit_tpu.data.shapenet import PartNormalDataset as JDataset
from prifit_tpu.models import get_module

torch.set_num_threads(1)

NPOINT, QUANTILE, SEED = 256, 0.04, 786


@pytest.fixture(scope="module")
def lift_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lift"))
    make_lift_benchmark(root, n_cats=2, n_per_cat=8, n_acd=2,
                        n_points=NPOINT, seed=0)
    return root


def _dataset(cls, root):
    return cls(osp.join(root, "shapenet"), npoints=NPOINT, split="test",
               normal_channel=False, rng=np.random.default_rng(0))


@pytest.fixture(scope="module")
def jax_side(lift_root):
    """The JAX probe's computation: flax init from ``SEED`` as the tool
    makes it, the eval forward of the test shapes (one ``__getitem__``
    each), ``cluster_batch`` and sklearn's NMI, per space."""
    model = get_module("pointnet2_part_seg_msg").get_model(
        num_parts=50, compute_dtype="f32")
    pts0 = jnp.asarray(np.random.default_rng(0).normal(size=(2, 64, 3)),
                       jnp.float32)
    cls0 = jnp.zeros((2, 16), jnp.float32)
    variables = jax.jit(lambda key: model.init(
        {"params": key, "sampling": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        pts0, cls0, train=True, embed=True))(jax.random.PRNGKey(SEED))
    ds = _dataset(JDataset, lift_root)
    items = [ds[i] for i in range(len(ds))]
    pts = np.stack([it[0] for it in items])
    segs = np.stack([it[2] for it in items])
    out = jax.jit(lambda v, p, c: model.apply(v, p, c, train=False,
                                              embed=True))(
        variables, jnp.asarray(pts), jnp.zeros((len(items), 16)))
    spaces = {}
    for space in ("embedding", "feat"):
        res = j_cluster(getattr(out, space), quantile=QUANTILE,
                        iterations=10, max_num_clusters=25)
        labels = np.asarray(res.labels)
        spaces[space] = (
            np.array([normalized_mutual_info_score(segs[b], labels[b])
                      for b in range(len(items))]),
            np.asarray(res.num_clusters), np.asarray(getattr(out, space)))
    return dict(variables=variables, pts=pts, spaces=spaces)


class _Once(torch.nn.Module):
    """The port's model, run once: later calls on the same points return
    the first call's outputs (both spaces come from one forward)."""

    def __init__(self, model):
        super().__init__()
        self.model, self.out = model, None

    def forward(self, pts, cls, **kw):
        if self.out is None:
            self.out = (pts.clone(), self.model(pts, cls, **kw))
        assert torch.equal(self.out[0], pts)
        return self.out[1]


@pytest.fixture(scope="module")
def port_model(jax_side):
    model = get_model(num_parts=50, compute_dtype="f32", device="cpu")
    model.load_state_dict(state_dict_from_jax(jax_side["variables"]),
                          strict=True)
    return _Once(model.eval())


@pytest.mark.parametrize("space", ["embedding", "feat"])
def test_probe_matches_jax(lift_root, jax_side, port_model, space,
                           monkeypatch):
    """The port's ``probe`` with JAX's weights: each batch's embedding
    within 1e-4 of JAX's largest entry; then, clustering JAX's embedding
    of the batch, JAX's cluster counts and NMI."""
    want_nmi, want_clusters, want_emb = jax_side["spaces"][space]
    errs = []

    def replay(emb, **kw):
        errs.append(float(np.abs(emb.numpy() - want_emb).max()))
        return cluster_batch(torch.tensor(want_emb), **kw)

    monkeypatch.setattr(T, "cluster_batch", replay)
    ds = _dataset(TDataset, lift_root)
    assert np.array_equal(ds[0][0], jax_side["pts"][0])
    ds = _dataset(TDataset, lift_root)           # the same draws again
    nmi, clusters = T.probe(port_model, ds, np.arange(len(ds)),
                            space=space, quantile=QUANTILE, batch=4,
                            device="cpu")
    assert len(errs) == 1 and errs[0] <= 1e-4 * np.abs(want_emb).max()
    assert len(nmi) == 4
    assert 2 <= want_clusters.min() and want_clusters.max() <= 5
    np.testing.assert_array_equal(clusters, want_clusters)
    np.testing.assert_allclose(nmi, want_nmi, rtol=0, atol=1e-12)


def test_main_merges_a_checkpoint(lift_root, tmp_path, capsys):
    """``--ckpt`` without ``extra_conv_emb`` (as a JAX supervised
    checkpoint lacks it): the head keeps its init from ``--seed``, the
    rest is the file's, and the kept names are printed."""
    src = T.build_model(5, "cpu")
    sd = {k: v for k, v in src.state_dict().items()
          if not k.startswith("extra_conv_emb")}
    path = str(tmp_path / "best_model")
    torch.save({"model_state_dict": sd, "epoch": 3}, path)
    seen = {}
    probe = T.probe

    def spy(model, *a, **kw):
        seen["sd"] = {k: v.clone() for k, v in model.state_dict().items()}
        return probe(model, *a, **kw)

    T.probe = spy
    try:
        nmi, clusters = T.main(["--data", lift_root, "--n", "2",
                                "--npoint", str(NPOINT), "--batch", "2",
                                "--space", "embedding", "--device", "cpu",
                                "--ckpt", path])
    finally:
        T.probe = probe
    init = T.build_model(SEED, "cpu").state_dict()
    for k, v in seen["sd"].items():
        want = init[k] if k.startswith("extra_conv_emb") else sd[k]
        assert torch.equal(v, want), k
    out = capsys.readouterr().out
    assert "['extra_conv_emb.weight', 'extra_conv_emb.bias']" in out
    assert f"probe[{path}] space=embedding split=test n=2" in out
    assert len(nmi) == 2 and ((0 <= nmi) & (nmi <= 1)).all()
    assert (clusters >= 1).all()


def test_probe_needs_a_device_without_cuda(lift_root, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.main(["--data", lift_root])
