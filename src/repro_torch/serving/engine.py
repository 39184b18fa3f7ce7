"""Minimal batched serving engine: prefill once, decode greedily/sampled.

Static-shape batching: a batch of requests is padded to a common prompt
length, prefilled in one pass, then decoded step by step with
``decode_step`` against a batch-major cache (fixed-``max_seq`` k/v for the
dense, vlm and audio families, the fixed-size RWKV state for ``ssm``).
``extra`` carries the vlm family's vision states or the audio family's
frames: whisper's prefill projects every decoder layer's cross k/v once into
the cache, and a vlm decode step projects them again from ``extra``, as in
the reference.  Prefill and decode run the plain SDPA, as in the reference:
the tri_attn kernel is reached only by a cache-less ``forward``.  An RWKV
prefill of a prompt whose length is a multiple of 64 runs the chunked WKV,
and so the wkv kernel; its decode steps (one token) run the scan.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import transformer as T


@dataclasses.dataclass
class GenerationResult:
    tokens: torch.Tensor         # (B, prompt + generated) int64
    steps: int


def greedy(logits, generator: torch.Generator | None = None,
           temperature: float = 0.0):
    """argmax over the last axis; with a temperature and a generator, a
    draw from softmax(logits / temperature).  The draw uses
    ``torch.Generator``, which cannot give ``jax.random``'s draws: sampled
    tokens differ from the reference's for the same seed (greedy ones do
    not)."""
    if temperature and generator is not None:
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        draw = torch.multinomial(flat, 1, generator=generator)
        return draw.reshape(logits.shape[:-1])
    return torch.argmax(logits, dim=-1)


def generate(params, cfg, prompts, max_new_tokens: int, extra=None,
             temperature: float = 0.0, seed: int = 0,
             eos_id: int | None = None) -> GenerationResult:
    """prompts: (B, S) ints, already padded; extra: (B, T, d) vision states
    or frames (vlm, audio), else None. Greedy when temperature=0."""
    device = params.embed.device
    prompts = torch.as_tensor(prompts, dtype=torch.int64, device=device)
    if extra is not None:      # once, not at every decode step
        extra = torch.as_tensor(extra, device=device).to(params.embed.dtype)
    b, s = prompts.shape
    if s + max_new_tokens > cfg.max_seq:
        raise ValueError(f"cache too small: prompt {s} + {max_new_tokens} new "
                         f"tokens > max_seq {cfg.max_seq}")

    logits, cache = T.prefill(params, cfg, prompts, extra)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = [prompts]
    tok = greedy(logits[:, -1:, : cfg.vocab_size], gen, temperature)
    done = torch.zeros((b, 1), dtype=torch.bool, device=device)
    n = 0
    for _ in range(max_new_tokens):
        out.append(tok)
        n += 1
        if eos_id is not None:
            done = done | (tok == eos_id)
            if bool(done.all()):
                break
        logits, cache = T.decode_step(params, cfg, tok, cache, extra)
        tok = greedy(logits[:, :, : cfg.vocab_size], gen, temperature)
    return GenerationResult(tokens=torch.cat(out, dim=1), steps=n)
