# The plain versions of prifit_torch/kernels/stochastic_round.py at commit
# 0adee2a, for the benchmark's reference (the kernels' launches left
# out); see benchmark/reference/__init__.py.
"""Stochastic rounding f32 -> bf16 with counter-hash bits, plain, and its
hash.

The bits are those of ``prifit_tpu/nn/mixed.py::_hash_bits16`` (the JAX
package's default ``hash`` source): a Weyl step and a splitmix32
finalizer over each element's flat index, seeded from a key of two uint32
words (plain Python ints).  ``sr(x)`` adds 16 of those bits to the f32
bit pattern and keeps the top half, so ``E[sr(x)] = x``.

The plain version works in int32 holding the uint32 bit patterns: adds
and products wrap modulo 2^32 in two's complement, which is uint32
arithmetic bit for bit (constants above 2^31 are passed as their signed
equivalents), and ``>>`` is arithmetic, so each right shift is masked to
the bits a logical shift keeps.
"""

import torch


_MASK32 = 0xFFFFFFFF
_W1, _W2 = 0x9E3779B9, 0x85EBCA6B
_M1, _M2 = 0x7FEB352D, 0x846CA68B


def hash_seed(key, offset: int = 0) -> int:
    """The hash's additive seed ``key[0] * 0x85EBCA6B + key[1]`` (uint32),
    as every kernel that rounds takes it.  The hash starts from ``index *
    0x9E3779B9 + seed``, so shifting every flat index by ``offset`` is
    adding ``offset * 0x9E3779B9`` to the seed: a data-parallel shard
    whose first element has the global flat index ``offset`` draws the
    bits the unsharded tensor would."""
    return (int(key[0]) * _W2 + int(key[-1]) + int(offset) * _W1) \
        & _MASK32


def _i32(c: int) -> int:
    """The int32 with the bit pattern of the uint32 ``c``."""
    return c - (1 << 32) if c >= 1 << 31 else c


def _xorshift_(x: torch.Tensor, s: int) -> torch.Tensor:
    """``x ^= x >> s`` with a logical shift, in place."""
    return x.bitwise_xor_((x >> s).bitwise_and_((1 << (32 - s)) - 1))


def hash_bits16(key, shape, device=None, offset: int = 0) -> torch.Tensor:
    """Uniform 16-bit noise (int32 values in [0, 2^16)) for every element of
    ``shape``, from the element's flat row-major index plus ``offset``."""
    numel = 1
    for s in shape:
        numel *= s
    x = torch.arange(numel, dtype=torch.int32, device=device)
    x.mul_(_i32(_W1)).add_(_i32(hash_seed(key, offset)))
    _xorshift_(x, 16).mul_(_i32(_M1))
    _xorshift_(x, 15).mul_(_i32(_M2))
    _xorshift_(x, 16)
    return x.bitwise_right_shift_(16).bitwise_and_(0xFFFF).reshape(shape)


def sr_bf16_plain(key, x: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """Stochastically round ``x`` (any float dtype, taken as f32) to bf16
    with :func:`hash_bits16` bits (``nn/mixed.py::sr_bf16``, hash source,
    in the JAX package).  Finite inputs only: the int32 add then never
    crosses the sign boundary, and the arithmetic shift leaves the top
    half as the signed int16 bf16 pattern."""
    y = x.float().contiguous().view(torch.int32) + hash_bits16(
        key, x.shape, x.device, offset)
    return y.bitwise_right_shift_(16).to(torch.int16).view(torch.bfloat16)


def sr_bf16(key, x: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """``sr(x)`` as bf16 for an f32 tensor ``x`` and a key of two uint32
    words.  ``offset`` is added to every flat index (see
    :func:`hash_seed`)."""
    return sr_bf16_plain(key, x, offset)
