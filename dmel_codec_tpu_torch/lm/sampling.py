"""Token sampling: repetition penalty -> top-k -> top-p -> temperature
(port of `dmel_codec_tpu/lm/sampling.py`).

Same order of operations as the reference: penalty on raw logits over the
previous-token window, top-k floor, top-p nucleus on the UN-tempered
logits, then temperature + softmax + sample. The window is fixed-size with
a validity mask. Every function works on the last axis and takes any
leading batch axes (logits [..., V], windows [..., W]): the JAX package
vmaps the single-row functions, here the batch is written out. Random
draws take an explicit `torch.Generator`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def apply_repetition_penalty(
    logits: torch.Tensor,
    previous_tokens: torch.Tensor,
    valid: torch.Tensor,
    penalty: float,
) -> torch.Tensor:
    """logits [..., V]; previous_tokens [..., W] int; valid [..., W] bool.

    A count scatter + select: a value scatter with duplicate indices (a
    token both in a valid and an invalid window slot) would pick an
    arbitrary winner."""
    hit = torch.zeros(logits.shape, dtype=torch.int32, device=logits.device)
    hit.scatter_add_(-1, previous_tokens.long(), valid.to(torch.int32))
    penalized = torch.where(logits < 0, logits * penalty, logits / penalty)
    return torch.where(hit > 0, penalized, logits)


def _nucleus_cutoff(vals: torch.Tensor, top_p: float) -> torch.Tensor:
    """vals [..., K] descending -> smallest kept value [..., 1] (the first
    position is always kept)."""
    cum = torch.cumsum(torch.softmax(vals, dim=-1), dim=-1)
    keep = cum <= top_p
    keep[..., 0] = True
    return torch.where(keep, vals, torch.inf).amin(dim=-1, keepdim=True)


def _sparse_filtered_logits(logits: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """Dense [..., V] logits with everything outside top-k/top-p set to
    -inf, WITHOUT a full-vocabulary sort (the slow vocab is 151936).

    Keeps values TIED with the k-th (the reference's `logits < kth ->
    -inf` pivot); once top-k filtering has run, the top-p cutoff is
    computable from the k largest values alone. Nucleus ties are
    VALUE-based: every logit equal to the boundary value is kept."""
    vals = torch.topk(logits, top_k, dim=-1).values
    logits = logits.masked_fill(logits < vals[..., -1:], -torch.inf)
    if top_p < 1.0:
        logits = logits.masked_fill(logits < _nucleus_cutoff(vals, top_p), -torch.inf)
    return logits


def _penalized(logits, previous_tokens, previous_valid, repetition_penalty):
    if previous_tokens is None or repetition_penalty == 1.0:
        return logits
    if previous_valid is None:
        previous_valid = torch.ones(previous_tokens.shape, dtype=torch.bool, device=logits.device)
    return apply_repetition_penalty(logits, previous_tokens, previous_valid, repetition_penalty)


def logits_to_probs(
    logits: torch.Tensor,
    previous_tokens: Optional[torch.Tensor] = None,
    previous_valid: Optional[torch.Tensor] = None,
    temperature: float = 1.0,
    top_k: int = 50,
    top_p: float = 1.0,
    repetition_penalty: float = 1.0,
) -> torch.Tensor:
    """logits [..., V] -> probs [..., V]."""
    logits = _penalized(logits, previous_tokens, previous_valid, repetition_penalty)

    if 0 < top_k < logits.shape[-1]:
        # sparse path: cutoffs from the top-k values, dense elementwise
        # filtering (keeps k-th ties like the reference), no [V] sort
        filtered = _sparse_filtered_logits(logits, top_k, top_p)
        return torch.softmax(filtered / max(temperature, 1e-5), dim=-1)

    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        logits = logits.masked_fill(logits < _nucleus_cutoff(sorted_logits, top_p), -torch.inf)

    return torch.softmax(logits / max(temperature, 1e-5), dim=-1)


def sample_token(
    generator: Optional[torch.Generator],
    logits: torch.Tensor,
    previous_tokens: Optional[torch.Tensor] = None,
    previous_valid: Optional[torch.Tensor] = None,
    temperature: float = 0.7,
    top_k: int = 50,
    top_p: float = 0.7,
    repetition_penalty: float = 1.2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (token ids [...] int64, probs [..., V])."""
    logits = _penalized(logits, previous_tokens, previous_valid, repetition_penalty)

    if 0 < top_k < logits.shape[-1]:
        # Sparse draw, tie-exact: the class draw happens in the [K] space,
        # with the cutoff-tied class's weight folded up by its FULL dense
        # multiplicity; where ties extend beyond the top-k and the tied
        # class was drawn, a dense uniform tie-break picks among them (it is
        # computed for every row and selected, so no value is read on the
        # host). Distribution is exactly the reference's softmax over
        # {logits >= cutoff}.
        temp = max(temperature, 1e-5)
        vals, idx = torch.topk(logits, top_k, dim=-1)  # desc
        cutoff = _nucleus_cutoff(vals, top_p) if top_p < 1.0 else vals[..., -1:]
        tied = vals == cutoff
        m_in = tied.sum(dim=-1, keepdim=True).clamp(min=1)
        at_cutoff = logits == cutoff
        m_total = torch.maximum(at_cutoff.sum(dim=-1, keepdim=True), m_in)
        scaled = vals.masked_fill(vals < cutoff, -torch.inf) / temp
        scaled = torch.where(tied, scaled + torch.log(m_total.float() / m_in), scaled)
        weights = torch.softmax(scaled.float(), dim=-1)
        choice = torch.multinomial(
            weights.reshape(-1, top_k), 1, generator=generator
        ).reshape(*vals.shape[:-1], 1)
        token_fast = idx.gather(-1, choice)
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
        token_tie = torch.where(at_cutoff, u, -1.0).argmax(dim=-1, keepdim=True)
        use_tie = (m_total > m_in) & (vals.gather(-1, choice) == cutoff)
        token = torch.where(use_tie, token_tie, token_fast)[..., 0]
        probs = torch.softmax(logits.masked_fill(logits < cutoff, -torch.inf) / temp, dim=-1)
        return token, probs  # probs: dense + tie-exact

    probs = logits_to_probs(logits, None, None, temperature, top_k, top_p, 1.0)
    flat = probs.reshape(-1, probs.shape[-1]).float()
    token = torch.multinomial(flat, 1, generator=generator).reshape(probs.shape[:-1])
    return token, probs
