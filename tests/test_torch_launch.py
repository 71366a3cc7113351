"""The last helpers of the port against the JAX package's: the deprecated
``launch.sessions`` shim, the serve CLI's pre-subcommand spelling
(``_legacy_argv``), the NTU graph helpers (``build_ntu_subsets``,
``static_graph``, the full-clip ``similarity_graph``), MLP channel
pruning (``prune_mlp_channels``) and ``lecun_init``."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.agcn import graph as jgraph
from repro.launch import serve as jserve
from repro.launch import sessions as jsessions
from repro.models.layers import common as jcommon
from repro.models.layers import mlp as jmlp
from repro_torch.core.agcn import graph
from repro_torch.launch import serve
from repro_torch.launch import sessions
from repro_torch.models.layers import common, mlp


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_sessions_shim_forwards_with_a_warning():
    import repro_torch.serving as serving
    assert dir(sessions) == dir(jsessions)
    for name in dir(jsessions):
        with pytest.warns(DeprecationWarning, match="repro_torch.serving"):
            got = getattr(sessions, name)
        assert got is getattr(serving, name)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(AttributeError, match="no attribute"):
            sessions.GcnService        # never part of the old surface


@pytest.mark.parametrize("argv", [
    ["--arch", "agcn-2s", "--reduced"],
    ["--arch", "agcn-2s", "--reduced", "--stream", "--batch", "2"],
    ["--arch", "agcn-2s", "--sessions", "4", "--qos", "preempt"],
    ["--arch=agcn-2s", "--sessions=8"],
    ["--arch", "smollm-360m", "--reduced", "--gen", "4"],
    ["--arch", "xlstm-1.3b", "--stream"],
])
def test_legacy_argv_maps_as_jax(argv, capsys):
    assert serve._legacy_argv(argv) == jserve._legacy_argv(argv)
    notes = capsys.readouterr().err.strip().splitlines()
    assert len(notes) == 2 and notes[0] == notes[1]
    assert "deprecated" in notes[0]


def test_legacy_spelling_serves(capsys):
    serve.main(["--arch", "smollm-360m", "--reduced", "--device", "cpu",
                "--prompt-len", "3", "--gen", "2", "--stream"])
    out = capsys.readouterr()
    assert "backend=cuda" in out.out and "tokens/s" in out.out
    assert "ignoring legacy flags" in out.err and "--stream" in out.err


def test_ntu_graph_helpers_match_jax():
    for k in (3, 4):
        got = graph.build_ntu_subsets(k)
        np.testing.assert_array_equal(got, jgraph.build_ntu_subsets(k))
        a = graph.static_graph(k)
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(jgraph.static_graph(k)))


@pytest.mark.parametrize("shape", [(2, 5, 25, 3, 4), (1, 9, 7, 16, 8)])
def test_similarity_graph_matches_jax(shape):
    N, T, V, C, Ce = shape
    x, wt, wp = _rand(0, N, T, V, C), _rand(1, C, Ce), _rand(2, C, Ce)
    got = graph.similarity_graph(*map(torch.from_numpy, (x, wt, wp)))
    want = jgraph.similarity_graph(jnp.asarray(x), jnp.asarray(wt),
                                   jnp.asarray(wp))
    assert got.shape == (N, V, V) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("keep", [0.25, 0.5, 0.9, 1.0, 0.0])
def test_prune_mlp_channels_matches_jax(keep):
    p = {"wi": _rand(3, 16, 40), "wg": _rand(4, 16, 40),
         "wo": _rand(5, 40, 16)}
    got = mlp.prune_mlp_channels({k: torch.from_numpy(v)
                                  for k, v in p.items()}, keep)
    want = jmlp.prune_mlp_channels({k: jnp.asarray(v)
                                    for k, v in p.items()}, keep)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = torch.from_numpy(_rand(6, 2, 3, 16))
    y = mlp.mlp({k: torch.from_numpy(v) for k, v in p.items()}, x,
                kept_ff=got)
    assert y.shape == (2, 3, 16)


def test_lecun_init_variance_and_meta():
    gen = torch.Generator().manual_seed(0)
    w = common.lecun_init(gen, (400, 300), 400)
    assert w.dtype == torch.float32
    assert abs(float(w.var()) - 1.0 / 400) < 0.05 / 400
    j = np.asarray(jcommon.lecun_init(jax.random.PRNGKey(0),
                                      (400, 300), 400))
    assert abs(float(j.var()) - float(w.var())) < 0.1 / 400
    with torch.device("meta"):
        m = common.lecun_init(None, (7, 5), 7)
    assert m.shape == (7, 5) and m.device.type == "meta"
