"""Training through the flash attention: the LM loss and every parameter's
gradient through the port's staged functions with ``attn_impl="flash"``
(K6 forward, K6-bwd backward; their plain versions on CPU tensors) against
``jax.value_and_grad`` of the same loss through the JAX package's staged
functions with ``attn_impl="flash"`` (the upstream Pallas TPU forward and
backward kernels, interpreted under ``pltpu.force_tpu_interpret_mode()``).

The loss is tiny_train's: embed_tokens -> decoder_layer x L ->
apply_final_norm -> lm_logits -> f32 log-softmax NLL of the next token.
The weights are the JAX package's bf16 init, carried across with
``params_from_numpy``; the ids come from a numpy seed.

Tolerance: the loss within 1e-3 relative; every parameter gradient within
a relative Frobenius error of 0.03.  Both sides run the whole model in
bf16 (weights, activations and cotangents), so each elementwise op and
each matmul output rounds to bf16 (relative 2^-8 = 0.0039) at points that
XLA:CPU and torch place differently, through 2 layers forward and back;
the flash attention adds its own bound (``bwd_tolerance``).  Measured:
0.019 (llama's layer-1 q_proj) and 0.014 (GPT-2's biases), and the same
with the naive attention on the port's side, so the floor is the bf16
model around the attention.  A planted fault (K6-bwd with di dropped)
reads 0.75 and more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tgq.models import PRESETS as JPRESETS
from tgq.models import causal_lm as jcl
from tgq_torch.kernels import causal_attention as K6
from tgq_torch.kernels import causal_attention_bwd as KB
from tgq_torch.models import PRESETS
from tgq_torch.models import causal_lm as tcl
from tgq_torch.models.convert import params_from_numpy

REL_FROB = 0.03


def _jax_loss(params, cfg, ids):
    x = jcl.embed_tokens(params, ids[:, :-1], cfg=cfg)
    cos, sin = jcl.rope_cache(cfg, ids.shape[1] - 1)
    for lp in params["model"]["layers"]:
        x = jcl.decoder_layer(lp, cfg, x, cos, sin, attn_impl="flash")
    logits = jcl.lm_logits(params, cfg, jcl.apply_final_norm(params, cfg, x))
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, ids[:, 1:, None], axis=-1))


def _torch_loss(params, cfg, ids, attn_impl="flash"):
    x = tcl.embed_tokens(params, ids[:, :-1], cfg=cfg)
    cos, sin = tcl.rope_cache(cfg, ids.shape[1] - 1, device=x.device)
    for lp in params["model"]["layers"]:
        x = tcl.decoder_layer(lp, cfg, x, cos, sin, attn_impl=attn_impl)
    logits = tcl.lm_logits(params, cfg, tcl.apply_final_norm(params, cfg, x))
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, ids[:, 1:, None]).mean()


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, f"{path}.{k}" if path else k)]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{path}.{i}")]
    return [(path, tree)]


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("preset", ["tiny-qwen3-kv128", "tiny-gpt2"])
def test_loss_and_grads_match_jax_flash(preset, monkeypatch):
    jcfg, cfg = JPRESETS[preset], PRESETS[preset]
    jparams = jcl.init_params(jcfg, jax.random.key(5))
    rng = np.random.default_rng(6)
    ids = rng.integers(0, cfg.vocab_size, size=(2, 129)).astype(np.int32)
    # one jitted program: run op by op, the interpreted kernels' callbacks
    # (which dispatch jnp ops themselves) can deadlock behind the ops
    # dispatched after them on a loaded host
    with pltpu.force_tpu_interpret_mode():
        jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, x: _jax_loss(p, jcfg, x)))(
            jparams, jnp.asarray(ids))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    for _, t in _leaves(params):
        t.requires_grad_()
    tids = torch.from_numpy(ids).long()
    before = (K6.launches, KB.launches)
    loss = _torch_loss(params, cfg, tids)
    loss.backward()
    assert (K6.launches, KB.launches) == before  # CPU: the plain versions
    assert abs(loss.item() - float(jloss)) <= 1e-3 * abs(float(jloss)), (loss.item(), float(jloss))
    want = dict(_leaves(params_from_numpy(jax.tree.map(np.asarray, jgrads))))
    got = {name: t.grad for name, t in _leaves(params)}
    assert got.keys() == want.keys()
    errs = {name: _rel(got[name].float(), want[name].float()) for name in want}
    assert max(errs.values()) <= REL_FROB, sorted(errs.items(), key=lambda kv: -kv[1])[:5]

    # the fault: K6-bwd with di dropped (the forward's o read as zeros)
    real = KB.causal_attention_bwd_plain
    monkeypatch.setattr(KB, "causal_attention_bwd_plain",
                        lambda q, k, v, o, *rest: real(q, k, v, torch.zeros_like(o), *rest))
    for _, t in _leaves(params):
        t.grad = None
    _torch_loss(params, cfg, tids).backward()
    bad = max(_rel(t.grad.float(), want[name].float()) for name, t in _leaves(params))
    assert bad >= 10 * REL_FROB, bad
