"""Token selection on the device (mirrors ``repro/serving/sampler.py``).

``sample(logits, rng, sp) -> (rng', tokens)`` picks one token per row of
``logits [S, V]``: greedy (the argmax, first index on ties; ``rng`` is
returned untouched) or, for temperature and top-k, the reference's
seeded draw. Each row's key is split, the fp32 row is divided by the
temperature, top-k keeps exactly k candidates, and the token is
``argmax(gumbel(sub) + row)`` (``jax.random.categorical``).

The keys and the random bits are JAX's own. ``jax.random`` keys are
threefry-2x32 keys, two uint32 words; the reference draws its sampling
bits in the partitionable threefry mode (``jax.threefry_partitionable``).
This module computes the same words with plain torch integer ops:

- :func:`threefry2x32`: the 20-round Threefry-2x32 hash (add, rotate and
  xor on 32-bit words held in int64 and masked to 32 bits);
- :func:`prng_key` ``(seed) = (seed >> 32, seed & 0xFFFFFFFF)``;
  :func:`fold_in` ``(key, d)`` = the hash of the count ``(0, d)``;
- :func:`split` (partitionable): the hashes of the counts ``(0, 0)``
  and ``(0, 1)``, the first carried on, the second used;
- :func:`random_bits` (partitionable): for element ``i`` of a row, the
  two words of the hash of the count ``(0, i)``, xored;
- :func:`gumbel`: ``-log(-log(u))`` of the uniform ``u`` JAX builds
  from those bits (the top 23 bits as the mantissa of a float in
  ``[1, 2)``, minus 1, scaled to ``[tiny, 1)``).

The integer words are bit-equal to JAX's on any device. The two ``log``
calls may round in the last place differently from XLA's, so a token
can differ from JAX's only where two candidates of ``logits / T +
gumbel`` are that close (a near-tie). Every op is a plain tensor op with
no host read, so the draw runs inside the captured decode step.

Keys are int64 tensors ``[S, 2]`` holding uint32 values.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

METHODS = ("greedy", "temperature", "top_k")

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: the smallest normal float32, the uniform's lower bound
_TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """How the serve step turns last-token logits into the next token:
    ``greedy`` (argmax), ``temperature`` (a draw from softmax(logits / T))
    or ``top_k`` (the same over the ``top_k`` largest logits only)."""

    method: str = "greedy"
    temperature: float = 1.0
    top_k: int = 0

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"unknown sampling method {self.method!r}; "
                             f"known: {METHODS}")
        if self.method != "greedy" and self.temperature <= 0:
            raise ValueError(f"temperature must be > 0, got {self.temperature}")
        if self.method == "top_k" and self.top_k <= 0:
            raise ValueError(f"top_k must be > 0, got {self.top_k}")


GREEDY = SamplingParams()


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counts ``(x0, x1)`` under the key ``(k0,
    k1)``; every operand an int64 tensor of uint32 values, broadcast
    together. Returns the two output words (``jax._src.prng``'s
    ``_threefry2x32_lowering``)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 ``[2]`` tensor."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in``: ``key [2]`` (or ``[n, 2]``) with the
    integers ``data [n]`` -> keys ``[n, 2]``."""
    data = data.to(torch.int64) & _MASK
    a, b = threefry2x32(key[..., 0:1], key[..., 1:2], torch.zeros_like(data)[:, None],
                        data[:, None])
    return torch.cat([a, b], dim=-1)


def split(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``key, sub = jax.random.split(key)`` per row of ``keys [S, 2]``,
    in the partitionable mode: the hashes of the counts (0, 0) and
    (0, 1)."""
    count = torch.arange(2, dtype=torch.int64, device=keys.device)[None]
    a, b = threefry2x32(keys[:, 0:1], keys[:, 1:2], torch.zeros_like(count),
                        count)
    return torch.stack([a[:, 0], b[:, 0]], -1), torch.stack([a[:, 1], b[:, 1]], -1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per element of ``[S, n]`` (``jax.random.bits`` in
    the partitionable mode, one key per row), as int64."""
    count = torch.arange(n, dtype=torch.int64, device=keys.device)[None]
    a, b = threefry2x32(keys[:, 0:1], keys[:, 1:2], torch.zeros_like(count),
                        count)
    return a ^ b


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,))`` per row of ``keys [S, 2]``:
    ``[S, n]`` float32."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp(u * (1.0 - _TINY) + _TINY, min=_TINY)
    return -torch.log(-torch.log(u))


def top_k_mask(row: torch.Tensor, k: int) -> torch.Tensor:
    """Keep exactly ``k`` entries of each row of ``row [S, V]``: those
    above the k-th largest value t, then the first ``k - count(row > t)``
    entries equal to t by index (``lax.top_k``'s order: lowest index
    first on ties). The rest become -inf. No sort and no host read, so
    the rule is the same on every device whatever order ``topk`` returns
    tied values in."""
    k = min(k, row.shape[-1])
    t = torch.topk(row, k, dim=-1).values[:, -1:]
    above = row > t
    tied = row == t
    room = k - above.sum(dim=-1, keepdim=True)
    keep = above | (tied & (torch.cumsum(tied.to(torch.int32), dim=-1) <= room))
    return torch.where(keep, row, float("-inf"))


def sample(logits: torch.Tensor, rng: torch.Tensor,
           sp: SamplingParams = GREEDY) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rng', tokens): one int32 token per row of ``logits [S, V]``.

    ``rng [S, 2]`` holds one key per row. Greedy takes the argmax (first
    index on ties, as ``jnp.argmax``) and returns ``rng`` itself; the
    other methods split each key, carry the first half and draw with the
    second."""
    if sp.method == "greedy":
        return rng, torch.argmax(logits, dim=-1).to(torch.int32)
    rng, sub = split(rng)
    row = logits.float() / sp.temperature
    if sp.method == "top_k":
        row = top_k_mask(row, sp.top_k)
    tok = torch.argmax(gumbel(sub, row.shape[-1]) + row, dim=-1)
    return rng, tok.to(torch.int32)
