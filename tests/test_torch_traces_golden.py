"""The golden trace replays through the port's ``GcnService``: replaying
``tests/data/traces/smoke.json`` must reproduce, byte for byte, every
(qos × policy) cell of ``golden_smoke.json`` and both cells of
``golden_saliency.json`` — the outcome digest of the per-tick scheduler
log and every counter the JAX golden tests check — on the port's
``reference`` backend with the goldens' weights (the JAX
``init_params(PRNGKey(0))``, bridged) and prune plan.  Replaying twice is
identical, and the port's own ``init_params`` weights (what
``chip_smoke.py`` serves with) and the ``cuda`` backend's plain versions
give the same digests: the outcome log holds host integers only."""
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.agcn import model as jmodel
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.agcn import engine, model
from repro_torch.core.pruning.plan import build_prune_plan
from repro_torch.serving import (SloConfig, Trace, bench_key,
                                 outcome_digest, replay)

CFG = get_config("agcn-2s", reduced=True)
DATA = pathlib.Path(__file__).resolve().parent / "data" / "traces"
GOLDEN = json.loads((DATA / "golden_smoke.json").read_text())
SALIENCY = json.loads((DATA / "golden_saliency.json").read_text())
SMOKE = Trace.load(str(DATA / "smoke.json"))


def _plans_bn(params, backend="reference"):
    """The goldens' plan: ``build_prune_plan`` on the weights' spatial
    convs, [1.0, 0.5, 0.5, 0.5] kept, cav-70-1, input skip 2, Q8.8, and BN
    statistics from the goldens' calibration batch."""
    sw = [b["Wk"].numpy() for b in params["blocks"]]
    pp = build_prune_plan(sw, CFG.gcn_channels, [1.0, 0.5, 0.5, 0.5],
                          "cav-70-1", input_skip=2)
    plan = engine.build_execution_plan(params, CFG, pp, quant=True,
                                       backend=backend)
    x = np.array(jax.random.normal(
        jax.random.PRNGKey(1),
        (2, CFG.gcn_frames, CFG.gcn_joints, CFG.gcn_in_channels)))
    return (plan,), (engine.collect_bn_stats(plan, torch.from_numpy(x)),)


@pytest.fixture(scope="module")
def plans_bn():
    jp = jmodel.init_params(jax_get_config("agcn-2s", reduced=True),
                            jax.random.PRNGKey(0))
    return _plans_bn(params_from_numpy(jax.tree.map(np.asarray, jp),
                                       device="cpu"))


def _replay_cell(plans_bn, qos, policy, trace=SMOKE, saliency=0.0,
                 backend="reference"):
    plans, bn = plans_bn
    shed_mode = "degrade" if policy == "slo-degrade" else "reject"
    pol = "slo" if policy.startswith("slo") else "demand"
    slo = (SloConfig(**{**GOLDEN["slo"], "shed_mode": shed_mode})
           if pol == "slo" else None)
    return replay(CFG, trace, backend=backend, qos=qos, policy=pol,
                  capacity_tiers=tuple(GOLDEN["tiers"]), slo_config=slo,
                  plans=plans, bn_stats=bn, record_outcomes=True,
                  saliency_thresh=saliency, device="cpu")


def _check_cell(out, want, policy):
    assert outcome_digest(out["outcomes"]) == want["outcome_digest"]
    assert out["ticks"] == want["ticks"]
    assert out["sessions"] == want["sessions"]
    assert out["preemptions"] == want["preemptions"]
    assert out["restores"] == want["restores"]
    assert out["deadline_missed"] == want["deadline_missed"]
    assert out["resize_events"] == want["migrations"]
    assert out["capacity_final"] == want["capacity_final"]
    for p, d in want["per_priority"].items():
        got = out["latency_ms_by_priority"][p]
        assert got["n"] == d["n"]
        assert got["first_logit_p50_ticks"] == d["first_logit_p50_ticks"]
        assert got["first_logit_p99_ticks"] == d["first_logit_p99_ticks"]
        assert got["e2e_p99_ticks"] == d["e2e_p99_ticks"]
    if policy.startswith("slo"):
        assert out["sessions_rejected"] == want["sessions_rejected"]
        assert out["sessions_degraded"] == want["sessions_degraded"]
        assert out["shed_windows"] == want["shed_windows"] > 0


def test_trace_and_goldens_agree():
    assert SMOKE.digest() == GOLDEN["trace_digest"] == \
        SALIENCY["trace_digest"]
    assert SMOKE.name == GOLDEN["trace"] == SALIENCY["trace"] == "smoke-v1"
    assert tuple(GOLDEN["tiers"]) == tuple(SALIENCY["tiers"]) == (2, 4)
    assert len(GOLDEN["cells"]) == 7 and len(SALIENCY["cells"]) == 2


@pytest.mark.parametrize("cell", sorted(GOLDEN["cells"]))
def test_golden_outcomes(plans_bn, cell):
    """Every (qos, policy) cell of golden_smoke.json, byte for byte."""
    qos, policy = cell.split("/")
    _check_cell(_replay_cell(plans_bn, qos, policy), GOLDEN["cells"][cell],
                policy)


@pytest.mark.parametrize("cell", sorted(SALIENCY["cells"]))
def test_golden_saliency_outcomes(plans_bn, cell):
    """Both cells of golden_saliency.json: the gated replay's digest, tick
    counters and skip accounting."""
    qos, policy = cell.split("/")
    want = SALIENCY["cells"][cell]
    out = _replay_cell(plans_bn, qos, policy,
                       saliency=SALIENCY["saliency_thresh"])
    _check_cell(out, want, policy)
    assert out["frames_scored"] == want["frames_scored"]
    assert out["frames_skipped"] == want["frames_skipped"] > 0
    assert out["skip_rate"] == pytest.approx(want["skip_rate"])
    assert out["saliency"] == SALIENCY["saliency_thresh"]


@pytest.mark.parametrize("saliency", [0.0, SALIENCY["saliency_thresh"]],
                         ids=["plain", "saliency"])
def test_replay_twice_is_identical(plans_bn, saliency):
    a = _replay_cell(plans_bn, "fifo", "slo", saliency=saliency)
    b = _replay_cell(plans_bn, "fifo", "slo", saliency=saliency)
    assert a["outcomes"] == b["outcomes"]
    assert a["frames_skipped" if saliency else "ticks"] == \
        b["frames_skipped" if saliency else "ticks"]


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_port_weights_give_the_same_digest(plans_bn, backend):
    """The port's own ``init_params`` weights (seed 0) replay the
    preempt/demand cell to the golden digest as the bridged JAX weights
    do, on the reference backend and on the cuda backend's plain
    versions; their logits differ, their outcomes do not."""
    own = _plans_bn(model.init_params(CFG, seed=0, device="cpu"), backend)
    a = _replay_cell(own, "preempt", "demand", backend=backend)
    b = _replay_cell(plans_bn, "preempt", "demand")
    want = GOLDEN["cells"]["preempt/demand"]["outcome_digest"]
    assert outcome_digest(a["outcomes"]) == outcome_digest(
        b["outcomes"]) == want
    la = {r.sid: r.logits for r in a["records"]}
    lb = {r.sid: r.logits for r in b["records"]}
    assert not all(np.allclose(la[k], lb[k]) for k in la)


def test_trace_row_carries_merge_axes(plans_bn):
    """Replay rows merge keyed on policy and trace (and device)."""
    out = _replay_cell(plans_bn, "fifo", "demand")
    assert (out["policy"], out["load"], out["trace"]) == \
        ("demand", "trace", "smoke-v1")
    k1 = bench_key(out)
    k2 = bench_key(_replay_cell(plans_bn, "fifo", "slo"))
    assert k1 != k2 and k1[-5:-3] == ("demand", "smoke-v1")
    assert k1[:2] == ("reference", "cpu") and k1[-2:] == (False, 0.0)
