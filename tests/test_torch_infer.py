"""The continuous-batching inference front-end (`serve.infer`) against the
JAX package's, on the CPU.

* Greedy tokens: the port's `InferenceFrontend` and the JAX package's
  run the same requests through the same admission and step sequence, on
  the JAX test suite's tiny LM and a 2-layer bf16 variant (weights
  carried across by `utils.interop.params_from_jax`), with dense
  attention and with the flash kernels' plain versions.  The port's
  logits differ from JAX's in the last bits, so the test first checks
  that every emitted token's top-2 logit margin exceeds 1e-4 (on the
  port's logits, from one causal forward over the finished sequence),
  then holds the tokens equal.
* The static buffer: a row's padded tail cannot change its logits.
* The JAX package's front-end cases: continuous batching, typed shed,
  hot swap with no dropped request (a new device tree, never the old one
  written), the drain budget's `TimeoutError`, admission validation, and
  the counters' rendering.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu.models import transformer as jt
from pytorch_ps_mpi_tpu.ops.flash_attention import flash_attention as jflash
from pytorch_ps_mpi_tpu.serve import InferenceFrontend as JFrontend
from pytorch_ps_mpi_tpu.utils.timing import \
    format_fault_stats as jformat_fault_stats
from pytorch_ps_mpi_tpu_torch.errors import InferShedError, PSRuntimeError
from pytorch_ps_mpi_tpu_torch.models import transformer as tt
from pytorch_ps_mpi_tpu_torch.ops.flash_attention import flash_attention
from pytorch_ps_mpi_tpu_torch.serve import InferenceFrontend, InferRequest
from pytorch_ps_mpi_tpu_torch.utils.interop import params_from_jax
from pytorch_ps_mpi_tpu_torch.utils.timing import format_fault_stats

MARGIN = 1e-4
# `tests/test_serve.py::_tiny_lm`, and a 2-layer bf16 variant.
TINY = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=1, d_ff=32,
            max_len=32)
TWO_BF16 = dict(vocab_size=48, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                max_len=32)
# (prompt, max_new): the first two start together, the third joins the
# running batch after one step, the fourth waits for a free slot.
REQUESTS = [([1, 2, 3], 6), ([4, 5, 6, 7, 8], 5), ([9, 10], 7),
            ([11, 3, 2, 1], 4)]


def _pair(cfg, dtype, flash, seed=1):
    """Both packages' LM of one config, flax's weights perturbed (so
    LayerNorm scales and biases are not trivial) and carried across."""
    jdtype = jax.numpy.bfloat16 if dtype == "bf16" else jax.numpy.float32
    tdtype = torch.bfloat16 if dtype == "bf16" else torch.float32
    jm = jt.TransformerLM(**cfg, dtype=jdtype, attn=(
        functools.partial(jflash, causal=True) if flash else None))
    rng = np.random.RandomState(seed)
    jp = {n: (np.asarray(p) + 0.3 * rng.randn(*p.shape)).astype(np.float32)
          for n, p in jt.build_lm(jm, seq_len=8, seed=seed).items()}
    tm = tt.TransformerLM(**cfg, dtype=tdtype, attn=(
        functools.partial(flash_attention, causal=True) if flash else None))
    tp, _ = params_from_jax(jp)
    return jm, jp, tm, tp


def _drive(fe):
    """Submit REQUESTS on a fixed schedule and drain; the tokens."""
    reqs = [fe.submit(p, max_new=n) for p, n in REQUESTS[:2]]
    fe.step()
    reqs.append(fe.submit(*REQUESTS[2][:1], max_new=REQUESTS[2][1]))
    reqs.append(fe.submit(*REQUESTS[3][:1], max_new=REQUESTS[3][1]))
    fe.drain()
    return [r.result(0) for r in reqs], fe.steps


def _check_margins(tm, tp, seqs, buf_len):
    """Every emitted token is the argmax of the port's logits at its
    position, with a top-2 margin above MARGIN; the sequences run padded
    to the buffer, as the front-end runs them."""
    for prompt, gen in seqs:
        full = prompt + gen
        toks = torch.zeros((1, buf_len), dtype=torch.int32)
        toks[0, :len(full)] = torch.tensor(full)
        with torch.inference_mode():
            logits = torch.func.functional_call(tm, tp, (toks,))[0]
        for j, tok in enumerate(gen):
            row = logits[len(prompt) - 1 + j]
            top2 = torch.topk(row, 2).values
            assert int(torch.argmax(row)) == tok
            assert float(top2[0] - top2[1]) > MARGIN, (prompt, j)


@pytest.mark.parametrize("cfg,dtype", [(TINY, "f32"), (TWO_BF16, "bf16")],
                         ids=["tiny-f32", "2-layer-bf16"])
@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_greedy_tokens_equal_jax(cfg, dtype, flash):
    jm, jp, tm, tp = _pair(cfg, dtype, flash)
    buf_len = 16
    jtoks, jsteps = _drive(JFrontend(jm, jp, max_batch=2, buf_len=buf_len,
                                     max_queue=8))
    fe = InferenceFrontend(tm, {n: p.numpy() for n, p in tp.items()},
                           max_batch=2, buf_len=buf_len, max_queue=8,
                           device="cpu")
    ttoks, tsteps = _drive(fe)
    _check_margins(tm, tp, [(p, g) for (p, _), g in zip(REQUESTS, ttoks)],
                   buf_len)
    assert ttoks == jtoks
    assert tsteps == jsteps
    assert [len(t) for t in ttoks] == [n for _, n in REQUESTS]


def test_padded_tail_cannot_change_a_rows_logits():
    _jm, _jp, tm, tp = _pair(TINY, "f32", flash=False)
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, 32, size=(1, 16)).astype(np.int32))
    other = toks.clone()
    other[0, 6:] = torch.from_numpy(rng.randint(0, 32, size=10).astype(
        np.int32))
    with torch.inference_mode():
        a = torch.func.functional_call(tm, tp, (toks,))
        b = torch.func.functional_call(tm, tp, (other,))
    torch.testing.assert_close(a[0, :6], b[0, :6], rtol=0, atol=0)


def _tiny():
    model = tt.TransformerLM(**TINY)
    return model, tt.build_lm(model, seed=0)


def _frontend(**kw):
    model, params = _tiny()
    kw.setdefault("device", "cpu")
    return InferenceFrontend(model, params, **kw)


def test_continuous_batching_requests_join_and_leave():
    fe = _frontend(max_batch=2, buf_len=16, max_queue=8)
    first = [fe.submit([1, 2, 3], max_new=4) for _ in range(2)]
    fe.step()
    late = fe.submit([4, 5], max_new=2)
    fe.drain()
    for req in first:
        assert len(req.result(0)) == 4
    assert len(late.result(0)) == 2
    assert late.tokens == [4, 5] + late.result(0)
    stats = fe.stats()
    assert stats["infer_requests"] == 3 and stats["infer_shed"] == 0
    assert set(stats) == {"infer_requests", "infer_shed", "param_swaps",
                          "steps", "queued", "active", "request_latency"}
    lat = stats["request_latency"]
    assert lat["n"] == 3 and lat["p95_s"] >= lat["p50_s"] > 0


def test_sheds_with_typed_error_at_overload():
    fe = _frontend(max_batch=1, buf_len=16, max_queue=2)
    admitted, shed = [], 0
    for i in range(6):
        try:
            admitted.append(fe.submit([1 + i % 8], max_new=2))
        except InferShedError as exc:
            shed += 1
            assert "back off" in str(exc)
    assert shed == 4 and len(admitted) == 2
    fe.drain()
    for req in admitted:
        assert len(req.result(0)) == 2
    stats = fe.stats()
    assert stats["infer_shed"] == shed and stats["infer_requests"] == 6
    assert isinstance(InferShedError("x"), PSRuntimeError)


def test_hot_swap_drops_no_request_and_builds_a_new_tree():
    model, params = _tiny()
    host = {n: p.numpy() for n, p in params.items()}
    bumped = {n: a + np.float32(0.01) for n, a in host.items()}

    class Source:
        def __init__(self):
            self.calls = 0

        def poll(self):
            self.calls += 1
            if self.calls == 2:
                return 1, bumped, True
            return 1, None, False

    fe = InferenceFrontend(model, host, max_batch=2, buf_len=16,
                           max_queue=8, params_source=Source(), device="cpu")
    before = fe._dev_params
    keep = {n: t.clone() for n, t in before.items()}
    reqs = [fe.submit([1, 2], max_new=6) for _ in range(2)]
    fe.drain()
    assert fe.stats()["param_swaps"] == 1
    for req in reqs:
        assert len(req.result(0)) == 6
    # A new tree holds the swapped params; the old one was never written,
    # and neither aliases the source's host arrays.
    assert fe._dev_params is not before
    for n in keep:
        torch.testing.assert_close(before[n], keep[n], rtol=0, atol=0)
        np.testing.assert_array_equal(fe._dev_params[n].numpy(), bumped[n])
        assert not np.shares_memory(fe._dev_params[n].numpy(), bumped[n])


def test_a_transport_blip_in_the_source_keeps_serving():
    class Flaky:
        def poll(self):
            raise ConnectionResetError("PS gone")

    fe = _frontend(max_batch=1, buf_len=8, max_queue=2,
                   params_source=Flaky())
    req = fe.submit([1, 2], max_new=3)
    fe.drain()
    assert len(req.result(0)) == 3 and fe.stats()["param_swaps"] == 0


def test_drain_budget_failure_is_not_a_shed():
    fe = _frontend(max_batch=1, buf_len=16, max_queue=2)
    req = fe.submit([1], max_new=2)
    with pytest.raises(TimeoutError, match="step budget"):
        fe.drain(max_steps=0)
    with pytest.raises(TimeoutError, match="not finished"):
        req.result(0)
    fe.drain()
    assert len(req.result(0)) == 2


def test_admission_validation():
    fe = _frontend(max_batch=1, buf_len=8, max_queue=2)
    with pytest.raises(ValueError, match="empty prompt"):
        fe.submit([], max_new=2)
    with pytest.raises(ValueError, match="exceeds the decode buffer"):
        fe.submit([1] * 7, max_new=4)
    with pytest.raises(ValueError, match="max_new"):
        fe.submit([1], max_new=0)
    for kw, what in ((dict(max_batch=0), "max_batch"),
                     (dict(buf_len=1), "buf_len"),
                     (dict(max_queue=0), "max_queue")):
        with pytest.raises(ValueError, match=what):
            _frontend(**kw)


def test_a_request_ends_at_the_buffers_end():
    fe = _frontend(max_batch=1, buf_len=8, max_queue=2)
    req = fe.submit([1] * 6, max_new=2)
    fe.drain()
    assert len(req.result(0)) == 2
    assert isinstance(req, InferRequest) and req.latency_s > 0


def test_the_frontend_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: device=None takes it")
    with pytest.raises(PSRuntimeError, match="no CUDA device"):
        _frontend(device=None)


@pytest.mark.parametrize("key", ["infer_requests", "infer_shed",
                                 "param_swaps"])
def test_frontend_counters_render_as_jax(key):
    fe = _frontend()
    assert key in fe.fault_stats
    assert format_fault_stats({key: 2}) == jformat_fault_stats({key: 2})
