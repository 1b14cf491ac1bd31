"""Tiny-MLP decoder as pure functions over a param pytree.

Function-class parity with the reference's ``ColorDecoder``
(``Projects/image_compression.py:54-68`` / ``pixel_comp.py:50-64`` of
21K1113/Neural_Image_Compression_V2): Linear(F→H) → GELU → Linear(H→H) →
GELU → Linear(H→3) → Sigmoid. GELU is the exact erf form (torch's default),
not the tanh approximation. Init matches torch.nn.Linear's default
(Kaiming-uniform weights with a=√5 ⇒ U(±1/√fan_in), bias U(±1/√fan_in))
so convergence behaviour is comparable.

Kept as a plain dict pytree (not flax) so the same weights feed both the
XLA path and the fused Pallas decode kernel without adapter layers.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

__all__ = ["init_mlp", "apply_mlp", "apply_mlp_tail", "mlp_param_bits",
           "mlp_num_params"]


def _linear_init(key, fan_in: int, fan_out: int, dtype):
    bound = 1.0 / math.sqrt(fan_in)
    kw, kb = jax.random.split(key)
    w = jax.random.uniform(kw, (fan_in, fan_out), dtype=dtype, minval=-bound, maxval=bound)
    b = jax.random.uniform(kb, (fan_out,), dtype=dtype, minval=-bound, maxval=bound)
    return w, b


def init_mlp(key, in_features: int, hidden: int, out_features: int = 3,
             dtype=jnp.float32) -> dict:
    k1, k2, k3 = jax.random.split(key, 3)
    w1, b1 = _linear_init(k1, in_features, hidden, dtype)
    w2, b2 = _linear_init(k2, hidden, hidden, dtype)
    w3, b3 = _linear_init(k3, hidden, out_features, dtype)
    return {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "w3": w3, "b3": b3}


def apply_mlp(params: dict, x, matmul_dtype=None):
    """x: [N, F] → [N, 3] in (0, 1).

    ``matmul_dtype`` (e.g. bf16) casts ONLY the dot inputs, accumulating
    in fp32 — the surgical mixed-precision mode: the matmuls run at bf16
    rate while biases/GELU/sigmoid (and everything upstream: grid
    gather/interp, QAT noise) stay fp32. With ``None`` the dtype follows
    the inputs unchanged."""
    if matmul_dtype is None:
        h = jax.nn.gelu(x @ params["w1"] + params["b1"], approximate=False)
        h = jax.nn.gelu(h @ params["w2"] + params["b2"], approximate=False)
        return jax.nn.sigmoid(h @ params["w3"] + params["b3"])

    def dot(a, w):
        return jnp.dot(a.astype(matmul_dtype), w.astype(matmul_dtype),
                       preferred_element_type=jnp.float32)

    h = jax.nn.gelu(dot(x, params["w1"]) + params["b1"].astype(jnp.float32),
                    approximate=False)
    h = jax.nn.gelu(dot(h, params["w2"]) + params["b2"].astype(jnp.float32),
                    approximate=False)
    return jax.nn.sigmoid(dot(h, params["w3"]) + params["b3"].astype(jnp.float32))


def apply_mlp_tail(params: dict, acc, matmul_dtype=None):
    """Layers 2..3 on a precomputed first-layer PREACTIVATION ``acc``
    [N, H] (i.e. x·W1 + b1, e.g. from the folded grid sampling of
    nic.grids.fastdecode.first_layer_acc): GELU → Linear → GELU →
    Linear → Sigmoid. Same ``matmul_dtype`` semantics as apply_mlp."""
    if matmul_dtype is None:
        h = jax.nn.gelu(acc, approximate=False)
        h = jax.nn.gelu(h @ params["w2"] + params["b2"], approximate=False)
        return jax.nn.sigmoid(h @ params["w3"] + params["b3"])

    def dot(a, w):
        return jnp.dot(a.astype(matmul_dtype), w.astype(matmul_dtype),
                       preferred_element_type=jnp.float32)

    h = jax.nn.gelu(acc.astype(jnp.float32), approximate=False)
    h = jax.nn.gelu(dot(h, params["w2"]) + params["b2"].astype(jnp.float32),
                    approximate=False)
    return jax.nn.sigmoid(dot(h, params["w3"]) + params["b3"].astype(jnp.float32))


def mlp_num_params(params: dict) -> int:
    return sum(int(p.size) for p in jax.tree.leaves(params))


def mlp_param_bits(params: dict) -> int:
    """Payload bits of the decoder weights (for bpp accounting)."""
    return sum(int(p.size) * p.dtype.itemsize * 8 for p in jax.tree.leaves(params))
