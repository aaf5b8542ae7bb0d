"""The decoder-only LM: the port's ``TransformerLM`` with flash attention,
its LM loss, ``synthetic_lm`` token rows (a copy of the port's
``data/datasets.py`` generator, rewritten in torch to run where the batch
is used) and the step's FLOPs."""

from __future__ import annotations

import functools

import torch

from .. import data, flops


def build(config: dict, dtype):
    from pytorch_ps_mpi_tpu_torch import flash_attention
    from pytorch_ps_mpi_tpu_torch.models import TransformerLM

    return TransformerLM(
        config["vocab_size"], d_model=config["d_model"],
        n_heads=config["n_heads"], n_layers=config["n_layers"],
        d_ff=config["d_ff"], max_len=config["max_len"], dtype=dtype,
        attn=functools.partial(flash_attention, causal=True))


def bind_loss(opt, module, aux) -> None:
    from pytorch_ps_mpi_tpu_torch.models import make_lm_loss

    opt.compile_step(make_lm_loss(module))


def lm_rows(n: int, seq_len: int, vocab: int, noise: float,
            g: torch.Generator, device) -> torch.Tensor:
    """``[n, seq_len + 1]`` int64 token rows (``synthetic_lm``): a uniform
    first token, then ``t+1 = (5t + 3) mod vocab``, then each token
    replaced by a uniform one with probability ``noise``.  The recurrence
    in closed form, ``t_k = (a_k t_0 + b_k) mod vocab``, with its
    coefficients worked out on the host in exact integers."""
    a, b, coef = 1, 0, []
    for _ in range(seq_len + 1):
        coef.append((a, b))
        a, b = (5 * a) % vocab, (5 * b + 3) % vocab
    ab = torch.tensor(coef, dtype=torch.int64, device=device)
    t0 = torch.randint(0, vocab, (n, 1), generator=g, device=device)
    toks = (ab[:, 0][None] * t0 + ab[:, 1][None]) % vocab
    flip = torch.rand(toks.shape, generator=g, device=device) < noise
    fresh = torch.randint(0, vocab, toks.shape, generator=g, device=device)
    return torch.where(flip, fresh, toks)


def batch_pool(traffic: dict, config: dict, seed: int,
               device) -> "list[dict]":
    """``pool`` global batches ``{tokens, targets, positions}`` (int32
    ``[B, S]``, targets shifted before sharding), as ``lm_batch`` makes
    them."""
    b = int(traffic["batch_per_rank"]) * int(traffic.get("world", 1))
    s = int(traffic["seq_len"])
    pool = []
    for i in range(int(traffic["pool"])):
        rows = lm_rows(b, s, int(config["vocab_size"]),
                       float(traffic["noise"]),
                       data.generator(seed, 2 + i, device), device)
        pool.append({
            "tokens": rows[:, :-1].to(torch.int32).contiguous(),
            "targets": rows[:, 1:].to(torch.int32).contiguous(),
            "positions": torch.arange(s, dtype=torch.int32, device=device)
            .expand(b, s).contiguous()})
    return pool


def items_per_batch(traffic: dict) -> int:
    """Tokens of a global batch."""
    b = int(traffic["batch_per_rank"]) * int(traffic.get("world", 1))
    return b * int(traffic["seq_len"])


def _matmul_params(c: dict) -> int:
    d, ff, v = c["d_model"], c["d_ff"], c["vocab_size"]
    per_layer = 3 * d * d + d * d + d * ff + ff * d
    return c["n_layers"] * per_layer + d * v


def lm_flops(c: dict, rows: int, seq: int) -> float:
    """Every dense layer's multiply-adds times two times three, and the
    causal attention's two products (only the unmasked query-key pairs)
    times three."""
    tokens = rows * seq
    matmul = 6.0 * _matmul_params(c) * tokens
    attention = 3.0 * 4.0 * c["d_model"] * flops.causal_pairs(seq) * rows \
        * c["n_layers"]
    return matmul + attention


def step_flops(config: dict, traffic: dict) -> float:
    return lm_flops(config, int(traffic["batch_per_rank"]),
                    int(traffic["seq_len"]))
