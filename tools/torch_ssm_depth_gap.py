"""How far the SSM and hybrid families' cached decode lies from their
cache-free forward in float32, at a chosen depth, in the JAX package and
in the port, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/torch_ssm_depth_gap.py \\
        [--arch xlstm-1.3b|zamba2-7b] [--layers 16] [--steps 31]

The config is the arch's full width with its depth cut to ``--layers``
and a 512-token vocabulary (the logits' width does not enter the
recurrences); weights are JAX's ``init_params`` from key 0, bridged to
the port.  One sequence of ``--steps`` tokens (numpy seed 0) goes through
each package's cache-free forward and, token by token, through its
cached decode (``serve_fn``).  Printed: each package's largest |logit|
difference between the two; the port's forward against JAX's and its
decode against JAX's; and the port's forward with the SSD scan in chunks
of 8 and of 1 against its own default (other float32 orders of one
function: the spread that rounding alone gives).  Memory: about 8 bytes
a parameter (both packages' float32 weights).
"""
import argparse
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import hybrid as jhybrid
from repro.models import registry as jregistry
from repro.models import ssm_model as jssm
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import hybrid, registry, ssm_model
from repro_torch.models.layers import mamba2, ssd, xlstm


def _decode(serve, n):
    return np.stack([serve(t) for t in range(n)], 1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="xlstm-1.3b",
                    choices=("xlstm-1.3b", "zamba2-7b"))
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--steps", type=int, default=31)
    args = ap.parse_args(argv)
    cut = dict(num_layers=args.layers, vocab_size=512)
    jcfg = dataclasses.replace(jax_get_config(args.arch), **cut)
    cfg = dataclasses.replace(get_config(args.arch), **cut)
    jmod, mod = ((jssm, ssm_model) if cfg.family == "ssm"
                 else (jhybrid, hybrid))
    jp = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    n = args.steps
    toks = np.random.default_rng(0).integers(0, 512, (1, n)).astype(np.int32)

    jfree = np.asarray(jmod.forward(jp, jnp.asarray(toks), jcfg)[0])
    jstep = jax.jit(lambda p, b, c: jregistry.serve_fn(p, b, c, jcfg))
    jc = [jregistry.init_cache(jcfg, 1, n, jnp.float32)]

    def jserve(t):
        lo, jc[0] = jstep(jp, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                               "pos": jnp.asarray(t, jnp.int32)}, jc[0])
        return np.asarray(lo)[:, -1]
    jdec = _decode(jserve, n)

    tt = torch.from_numpy(toks)
    with torch.inference_mode():
        free = mod.forward(tp, tt, cfg)[0].numpy()
        cache = registry.init_cache(cfg, 1, n, device="cpu")

        def serve(t):
            lo, _ = registry.serve_fn(tp, {
                "tokens": tt[:, t:t + 1],
                "pos": torch.tensor(t, dtype=torch.int32)}, cache, cfg,
                "reference")
            return lo[:, -1].numpy()
        dec = _decode(serve, n)
        spread = {}
        for chunk in (8, 1):
            for m in (xlstm, mamba2):
                m.ssd_scan = functools.partial(ssd.ssd_scan, chunk=chunk)
            spread[chunk] = float(np.abs(
                mod.forward(tp, tt, cfg)[0].numpy() - free).max())
        for m in (xlstm, mamba2):
            m.ssd_scan = ssd.ssd_scan

    def gap(a, b):
        return float(np.abs(a - b).max())
    print(f"{args.arch} at {args.layers} layers, d_model {cfg.d_model}, "
          f"{n} tokens; max |logit| {np.abs(jfree).max():.4g}")
    print(f"  JAX:  cached decode vs cache-free forward {gap(jdec, jfree):.3g}")
    print(f"  port: cached decode vs cache-free forward {gap(dec, free):.3g}")
    print(f"  port vs JAX: forward {gap(free, jfree):.3g}, decode "
          f"{gap(dec, jdec):.3g}")
    print(f"  port forward, SSD chunk 8 / 1 vs 128: {spread[8]:.3g} / "
          f"{spread[1]:.3g}")


if __name__ == "__main__":
    main()
