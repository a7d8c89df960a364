"""The control of the correctness check: the reference computed in the
nearest precision below the one the configuration states.

Inside the forward of the encoder's modules (the configuration's
``encoder_modules``): for ``"fp8"`` (below ``mxsr``, ``mx``, ``bf16``)
every value cast to bf16 is rounded on to fp8 e4m3, so the activations
and weights the configuration stores in bf16 are stored in fp8; for
``"tf32"`` (below ``f32``) every f32 operand of a matrix product is
rounded to TF32 (10 explicit mantissa bits, to nearest even), as
``allow_tf32`` would run it.  The convex loss (clustering, fit, chamfer),
which the configurations state in f32, computes its products in TF32
(:func:`lower_convex`).  The rounding passes the gradient straight
through, so the backward stays the configuration's.  It is done by
wrapping ``torch.Tensor.to`` or torch's product functions while an
encoder module's forward or the convex loss runs."""

import contextlib

import torch

_TO = torch.Tensor.to
PRODUCTS = ("matmul", "mm", "bmm")


def _straight_through(x, r):
    """``r``'s value with ``x``'s gradient."""
    return x + (r - x).detach()


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    i = x.detach().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return _straight_through(x, i.view(torch.float32))


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    r = _TO(_TO(x.detach(), torch.float8_e4m3fn), x.dtype)
    return _straight_through(x, r)


def _fp8_casts(active):
    def to(self, *args, **kwargs):
        out = _TO(self, *args, **kwargs)
        if active[0] and out.dtype == torch.bfloat16 \
                and self.dtype != torch.bfloat16:
            out = round_fp8(out)
        return out
    return [(torch.Tensor, "to", to)]


def _tf32_products(active):
    def wrap(fn):
        def product(*args, **kwargs):
            if active[0]:
                args = tuple(round_tf32(a) if isinstance(a, torch.Tensor)
                             and a.dtype == torch.float32 else a
                             for a in args)
            return fn(*args, **kwargs)
        return product
    out = [(torch, name, wrap(getattr(torch, name))) for name in PRODUCTS]
    out.append((torch.Tensor, "__matmul__", wrap(torch.Tensor.__matmul__)))
    return out


PATCHES = {"fp8": _fp8_casts, "tf32": _tf32_products}


@contextlib.contextmanager
def lower_precision(model, modules, precision: str):
    """While open, ``model``'s submodules named ``modules`` compute their
    forward in ``precision`` (``"fp8"`` or ``"tf32"``)."""
    active = [0]
    patches = PATCHES[precision](active)
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in
             patches]

    def pre(_m, _a):
        active[0] += 1

    def post(_m, _a, _o):
        active[0] -= 1

    hooks = []
    for name in modules:
        sub = getattr(model, name)
        hooks += [sub.register_forward_pre_hook(pre),
                  sub.register_forward_hook(post)]
    for owner, name, fn in patches:
        setattr(owner, name, fn)
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
        for h in hooks:
            h.remove()


@contextlib.contextmanager
def lower_convex(model_module):
    """While open, the convex loss that the model module ``model_module``
    calls computes the operands of its products in TF32."""
    active = [0]
    patches = _tf32_products(active)
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in
             patches]
    real = model_module.convex_loss

    def convex_loss(*args, **kwargs):
        active[0] += 1
        try:
            return real(*args, **kwargs)
        finally:
            active[0] -= 1

    for owner, name, fn in patches:
        setattr(owner, name, fn)
    model_module.convex_loss = convex_loss
    try:
        yield
    finally:
        model_module.convex_loss = real
        for owner, name, fn in saved:
            setattr(owner, name, fn)
