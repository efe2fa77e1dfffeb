"""Deterministic synthetic token pipeline for LM training and serving;
port of ``repro/data/tokens.py``.

No corpus is read. The stream is a seeded mixture that is (a)
deterministic in (seed, step), (b) non-uniform (Zipfian marginals plus
local repetition), so cross-entropy falls in a short training run, and
(c) cheap to make. Each of the B·K streams draws its S tokens from the
Zipf marginal, copies the previous token with probability 0.3, and sets
every 64th position to the header id 0.

The draws are the port's own: a ``torch.Generator`` on the CPU seeded
from (seed, step). The reference's threefry bits cannot be matched, so
tests that compare the two packages hand the reference's tokens to both.

MusicGen-style multi-codebook streams add the delay pattern: codebook k
is shifted right by k steps (arXiv:2306.05284 §2.2), with token 0 as the
pad/start id.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_codebooks: int = 1
    seed: int = 0
    zipf_a: float = 1.2  # Zipf exponent of the marginal distribution


def _zipf_probs(vocab: int, a: float) -> Tensor:
    """P(id) ∝ (id + 1)^−a, in float64."""
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64)
    w = ranks ** -a
    return w / w.sum()


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator seeded from (seed, step) through numpy's
    ``SeedSequence``, so nearby pairs give unrelated streams."""
    word = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(word[0]) << 32 | int(word[1]))


def synth_batch(cfg: TokenPipelineConfig, step: int) -> Tensor:
    """A batch of tokens (B, S) or, with K codebooks, (B, S, K) (delay
    pattern applied), int32 on the CPU, deterministic in (seed, step)."""
    g = _generator(cfg.seed, step)
    S = cfg.seq_len
    n_streams = cfg.global_batch * max(cfg.num_codebooks, 1)
    probs = _zipf_probs(cfg.vocab_size, cfg.zipf_a)
    base = torch.multinomial(probs, n_streams * S, replacement=True,
                             generator=g).view(n_streams, S)
    # local repetition: with p = 0.3 copy the previous token (bigram mass)
    rep = torch.rand((n_streams, S), generator=g) < 0.3
    shifted = torch.cat([base[:, :1], base[:, :-1]], dim=1)
    toks = torch.where(rep, shifted, base)
    # periodic motif: every 64 tokens a "header" id
    toks[:, ::64] = 0
    if cfg.num_codebooks > 1:
        toks = toks.view(cfg.global_batch, cfg.num_codebooks, S).transpose(1, 2)
        toks = apply_delay_pattern(toks)
    else:
        toks = toks.view(cfg.global_batch, S)
    return toks.to(torch.int32).contiguous()


def apply_delay_pattern(tokens: Tensor) -> Tensor:
    """MusicGen's delay: codebook k shifted right by k, pad id 0.
    (B, S, K) → (B, S, K), same dtype (reference :73)."""
    B, S, K = tokens.shape
    cols = []
    for k in range(K):
        pad = torch.zeros((B, min(k, S)), dtype=tokens.dtype, device=tokens.device)
        cols.append(torch.cat([pad, tokens[:, :max(S - k, 0), k]], dim=1))
    return torch.stack(cols, dim=-1)


def batches(cfg: TokenPipelineConfig, start_step: int = 0) -> Iterator[Tensor]:
    step = start_step
    while True:
        yield synth_batch(cfg, step)
        step += 1


def lm_loss(logits: Tensor, tokens: Tensor) -> Tensor:
    """Next-token cross-entropy, the mean over every predicted position
    (and codebook). logits (B, S, V) or (B, S, K, V); tokens (B, S[, K])
    (reference :91): log-softmax in fp32."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    pred = logp[:, :-1]
    tgt = tokens[:, 1:].long()
    nll = -torch.gather(pred, -1, tgt[..., None])[..., 0]
    return torch.mean(nll)
