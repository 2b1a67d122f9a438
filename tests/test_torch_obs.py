"""The port's observability layer and sanitizers (``repro_torch.obs``,
``repro_torch.analysis.sanitize``) against the JAX package's
(``repro.obs``, ``repro.analysis.sanitize``), on the CPU.

Tolerances: packs, decoded rows, file contents and the analytic comm model
are compared exactly (same formulas, same float64 file values).  A nano run
of each package from the same init and batches is compared by its
scalars.csv: loss / last_loss / gamma within the 2e-3 of
``test_torch_dsm.py::test_run_training_matches_reference_history``, and the
first row's sign-dynamics columns within the 1e-3 of
``test_torch_dsm.py``'s per-step pack check.  Runs with and without the
observability layer are held bit for bit.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from benchmarks import comm as JCOMM
from benchmarks.tables import NANO as J_NANO
from repro.models import transformer as JT
from repro.obs import ledger as JL
from repro.obs import metrics as JM
from repro.obs import sinks as JS
from repro.obs import summarize as JSUM
from repro.obs import tracing as JTRC
from repro.train import trainer as JTR
from repro_torch.analysis import sanitize as SAN
from repro_torch.checkpoint import checkpoint as CK
from repro_torch.configs.nano import NANO
from repro_torch.data.pipeline import MarkovCorpus, dsm_batches
from repro_torch.distributed import spawn
from repro_torch.distributed import zero as Z
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.obs import comm_model as CM
from repro_torch.obs import ledger as L
from repro_torch.obs import metrics as M
from repro_torch.obs import sinks as OS
from repro_torch.obs import summarize as SUM
from repro_torch.obs import tracing as TRC
from repro_torch.robustness import guards as G
from repro_torch.train import trainer as TR

import torch_ranks

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SMALL = dict(n_workers=2, tau=2, steps=4, b_micro=2, seq=32, eval_every=2)
# the same-init run: test_torch_dsm.py's shapes and the launcher's rates
SAME_INIT = dict(n_workers=4, tau=4, steps=4, b_micro=2, seq=64, peak_lr=5e-3,
                 global_lr=0.3, eval_every=2, eval_batch=8, log_every=1)
DYNAMICS = ("pg_l1", "pg_l2", "pg_density", "m_l1", "update_cos", "sign_agree")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(s, **kw):
    return TR.run_training(NANO, s, device="cpu", **kw)


# ---------------------------------------------------------------------------
# Packs and decoded rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gamma", [None, 0.0125])
def test_minimal_pack_matches_reference(gamma):
    ours = M.minimal_pack(torch.tensor(3.25), None if gamma is None else torch.tensor(gamma))
    theirs = np.asarray(JM.minimal_pack(jax.numpy.float32(3.25),
                                        None if gamma is None else jax.numpy.float32(gamma)))
    np.testing.assert_array_equal(ours.numpy(), theirs)      # NaN where NaN


def _one_round(algorithm, guards=False):
    """The metrics dict of one nano outer step of ``algorithm``."""
    s = TR.TrainSettings(algorithm=algorithm, **SMALL)
    lay = T.layout(NANO)
    init, step, _, _ = TR.build_algorithm(lambda p, mb: T.loss_fn(p, mb, NANO), s, lay)
    state = init(T.init_params(torch.Generator().manual_seed(0), NANO), s.n_workers)
    raw = next(dsm_batches(MarkovCorpus(NANO.vocab_size, seed=1), s.n_workers, s.tau, 1,
                           s.b_micro, s.seq, seed=0))
    batch = {"tokens": torch.as_tensor(raw["tokens"], dtype=torch.long)}
    rng = torch.Generator().manual_seed(0)
    if guards:
        _, _, metrics = G.make_guarded_step(step, nonfinite=True)(state, G.init_guard(),
                                                                  batch, rng)
    else:
        _, metrics = step(state, batch, rng)
    return metrics


@pytest.mark.parametrize("algorithm,guards", [("dsm", False), ("dsm", True), ("slowmo", False),
                                              ("slowmo", True), ("perstep", False)])
def test_decoded_rows_match_reference(algorithm, guards):
    """A DSM step's row is its pack; a baseline's has the loss / gamma (and
    guard) slots with NaN elsewhere, in the same places as the reference's
    ``_decode_metrics_row`` puts them."""
    fetched = M.fetch_metrics([_one_round(algorithm, guards)])[0]
    ours = M.decode_metrics_row(fetched)
    theirs = JTR._decode_metrics_row(fetched)
    np.testing.assert_array_equal(ours, theirs)
    assert ours.dtype == theirs.dtype == np.float64
    if algorithm == "dsm":
        assert np.isfinite(ours).all()
    else:
        assert np.isnan(ours[M.IDX["pg_l1"]]) and np.isfinite(ours[M.IDX["loss"]])
        assert np.isfinite(ours[M.IDX["guard_ok"]]) == guards


def test_fetch_keeps_order_and_values_of_every_round():
    rounds = [{"pack": torch.arange(12.0) + i} for i in range(3)] + [
        {"loss": torch.tensor(2.5), "gamma": torch.tensor(0.1), "guard_ok": torch.tensor(False)}]
    got = M.fetch_metrics(rounds)
    for i in range(3):
        np.testing.assert_array_equal(got[i]["pack"], np.arange(12.0) + i)
    assert float(got[3]["loss"]) == 2.5 and not bool(got[3]["guard_ok"])


# ---------------------------------------------------------------------------
# File format, both directions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [(OS, JS), (JS, OS), (OS, OS)],
                         ids=["port-to-reference", "reference-to-port", "port-to-port"])
def test_run_writer_roundtrip_resume_and_truncated_tail(tmp_path, writer, reader):
    run_dir = str(tmp_path / "run")
    manifest = writer.build_manifest(run_name="run", extra={"note": "t"})
    with writer.RunWriter(run_dir, manifest) as w:
        w.event("started", steps=3)
        w.metrics_row(1, np.arange(M.N_METRICS, dtype=np.float64))
        w.span("eval", 0.25, step=1)
    man, events, rows = reader.read_run(run_dir)
    assert man["run_name"] == "run" and man["metric_names"] == list(M.METRIC_NAMES)
    assert [e["kind"] for e in events] == ["started", "span"]
    assert rows[0]["step"] == 1 and rows[0]["guard_ok"] == float(M.IDX["guard_ok"])
    with writer.RunWriter(run_dir, manifest, resume=True) as w:
        w.event("resumed", step=1)
        w.metrics_row(2, np.arange(M.N_METRICS, dtype=np.float64) + 1)
    with open(os.path.join(run_dir, "events.jsonl"), "a") as f:
        f.write('{"kind": "trunc')
    with open(os.path.join(run_dir, "scalars.csv"), "a") as f:
        f.write("3,0.5,0.1")
    _, events, rows = reader.read_run(run_dir)
    assert [e["kind"] for e in events] == ["started", "span", "resumed"]
    assert [r["step"] for r in rows] == [1, 2]
    with open(os.path.join(run_dir, "scalars.csv")) as f:
        assert sum(line.startswith("step,") for line in f) == 1


def test_file_format_is_the_reference_s():
    assert OS.SCALAR_HEADER == JS.SCALAR_HEADER
    assert M.METRIC_NAMES == JM.METRIC_NAMES
    theirs = JS.build_manifest(run_name="r")
    ours = OS.build_manifest(run_name="r")
    assert set(theirs) - {"jax_version"} <= set(ours)
    assert {"torch_version", "cuda_version", "device_name"} <= set(ours)
    assert (ours["backend"], ours["device_count"], ours["device_name"]) == ("cpu", 1, "cpu")
    assert OS._jsonable({"d": torch.bfloat16, "t": torch.tensor([1.5, 2.0]),
                         "n": np.float32(0.5)}) == {"d": "bfloat16", "t": [1.5, 2.0], "n": 0.5}
    pack = np.linspace(0, 1, M.N_METRICS)
    assert OS.pack_to_dict(pack) == JS.pack_to_dict(pack)
    with pytest.raises(ValueError, match="expected 12"):
        OS.pack_to_dict(np.zeros(M.N_METRICS - 1))


# ---------------------------------------------------------------------------
# Comm model and ledger
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", JCOMM.LOCAL_STEP_ALGOS + ("perstep", "mv_signsgd"))
@pytest.mark.parametrize("tau", [1, 12])
def test_comm_model_matches_reference(algo, tau):
    for payload in (1 << 20, 495_528_960):
        assert CM.wire_bytes_for_payload(payload, algo, tau) == \
            JCOMM.wire_bytes_for_payload(payload, algo, tau)
    assert (CM.LOCAL_STEP_ALGOS, CM.REDUCE_CLASS, CM.GATHER_CLASS, CM.PHASES) == (
        JCOMM.LOCAL_STEP_ALGOS, JCOMM.REDUCE_CLASS, JCOMM.GATHER_CLASS, JCOMM.PHASES)
    with pytest.raises(ValueError):
        CM.wire_bytes_for_payload(1, "nope", tau)


@pytest.mark.parametrize("phase", ["global_dense", "global_zero", "local"])
def test_degenerate_ledger_matches_reference(phase):
    """On one device neither package sees a collective: the records agree
    field for field (the reference's from the compiled step of a buffer of
    the same size and dtype)."""
    n = 5003
    theirs = JL.compile_time_ledger(lambda x: x * 2, (jax.numpy.zeros(n),),
                                    params={"w": jax.numpy.zeros(n, jax.numpy.bfloat16)},
                                    algo="dsm", tau=12, phase=phase)
    ours = L.observed_ledger({}, group_numels=(n,), n_param_leaves=1, group_itemsizes=(2,),
                             algo="dsm", tau=12, phase=phase, world=1)
    extra = {"source", "by_kind"}
    assert {k: v for k, v in ours["observed"].items() if k not in extra} == theirs["observed"]
    assert {k: v for k, v in ours.items() if k != "observed"} == {
        k: v for k, v in theirs.items() if k != "observed"}
    with pytest.raises(ValueError, match="phase must be one of"):
        L.observed_ledger({}, group_numels=(n,), n_param_leaves=1, group_itemsizes=(2,),
                          algo="dsm", tau=1, phase="nope", world=1)


def test_ledger_classes_and_delta():
    before = {"scatter_rows": {"calls": 1, "bytes": 100}}
    after = {"scatter_rows": {"calls": 2, "bytes": 300}, "all_gather_shards": {"calls": 1,
                                                                               "bytes": 50},
             "all_reduce_sum": {"calls": 1, "bytes": 28}, "gather_to_root": {"calls": 1,
                                                                            "bytes": 7}}
    delta = L.stats_delta(before, after)
    assert delta["scatter_rows"] == {"calls": 1, "bytes": 200}
    rec = L.observed_ledger(delta, group_numels=(100,), n_param_leaves=3,
                            group_itemsizes=(2,), algo="dsm", tau=2, phase="global_zero",
                            world=4)
    obs = rec["observed"]
    assert (obs["reduce_ops"], obs["reduce_bytes"]) == (2, 228)
    assert (obs["gather_ops"], obs["gather_bytes"]) == (1, 50)
    assert (obs["other_ops"], obs["other_kinds"]) == (1, ["gather_to_root"])
    assert rec["ratio"] == {"reduce": 228 / 400, "gather": 50 / 400}


def _zero_bytes(n_workers, world, tau):
    """Hand count of one ZeRO round's bytes per rank (nano is f32, one
    worker per rank): the worker chunks to every owner, the rank's shard
    into the all-gather, the (tau, 1) losses and the 7 stat sums."""
    n = T.layout(NANO).numel
    chunk = Z.chunk_size(n, world)
    return {"reduce": world * chunk * 4 + 7 * 4, "gather": chunk * 4 + tau * 4, "n": n}


@pytest.mark.parametrize("world", [2, 4])
def test_comm_ledger_over_ranks_equals_the_round_s_comm_stats(tmp_path, world):
    """``world`` gloo ranks, one worker each, ZeRO and the device-parallel
    local phase, one outer step with a run directory: rank 0 writes one
    ledger whose observed bytes are the round's CommStats and the hand
    count, and every rank returns the same final metrics."""
    s = TR.TrainSettings(zero_sharded=True, device_parallel_local=True, run_dir=str(tmp_path),
                         **{**SMALL, "n_workers": world, "steps": 1, "eval_every": 1})
    x0 = T.init_params(torch.Generator().manual_seed(0), NANO)
    ranks = spawn.run_ranks(torch_ranks.train_rank, world, (NANO, [s], "cpu", x0),
                            timeout_s=300, group_timeout_s=60)
    _, events, rows = OS.read_run(str(tmp_path))
    ledgers = [e for e in events if e["kind"] == "comm_ledger"]
    assert len(ledgers) == 1 and len([e for e in events if e["kind"] == "finished"]) == 1
    led, want = ledgers[0], _zero_bytes(world, world, s.tau)
    comm = ranks[0][0]["comm"]
    assert led["observed"]["by_kind"] == {k: {"calls": v["calls"], "bytes": v["bytes"]}
                                          for k, v in comm.items()}
    assert led["observed"]["reduce_bytes"] == want["reduce"]
    assert led["observed"]["gather_bytes"] == want["gather"]
    assert sum(v["bytes"] for v in comm.values()) == want["reduce"] + want["gather"]
    assert not led["degenerate_mesh"] and led["mesh_devices"] == world
    assert led["ratio"]["reduce"] == want["reduce"] / (want["n"] * 4)
    assert [r["step"] for r in rows] == [1]
    assert all(r[0]["final_metrics"] == ranks[0][0]["final_metrics"] for r in ranks)
    assert all(r[0]["launches"] == {"dsm_update": 0, "adamw_update": 0} for r in ranks)


def test_comm_ledger_of_one_process_is_degenerate(tmp_path):
    s = TR.TrainSettings(zero_sharded=True, device_parallel_local=True, run_dir=str(tmp_path),
                         **{**SMALL, "steps": 1, "eval_every": 1})
    _run(s)
    _, events, _ = OS.read_run(str(tmp_path))
    led = next(e for e in events if e["kind"] == "comm_ledger")
    assert led["degenerate_mesh"] and led["ratio"] == {"reduce": None, "gather": None}
    assert led["observed"]["reduce_bytes"] == led["observed"]["gather_bytes"] == 0


# ---------------------------------------------------------------------------
# The same init in both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("both")
    jdir, tdir = str(root / "jax_run"), str(root / "torch_run")
    JTR.run_training(J_NANO, JTR.TrainSettings(run_dir=jdir, **SAME_INIT))
    jparams = JT.init_params(jax.random.PRNGKey(0), J_NANO)
    params = convert.from_jax_numpy(jax.tree.map(np.asarray, jparams), NANO, 1)
    res = _run(TR.TrainSettings(run_dir=tdir, **SAME_INIT), params=params)
    return jdir, tdir, res


def test_same_init_scalars_match_reference(both_runs):
    jdir, tdir, res = both_runs
    _, _, jrows = JS.read_run(jdir)
    _, _, rows = OS.read_run(tdir)
    assert [r["step"] for r in rows] == [r["step"] for r in jrows] == [1, 2, 3, 4]
    for name in ("loss", "last_loss", "gamma"):
        np.testing.assert_allclose([r[name] for r in rows], [r[name] for r in jrows],
                                   rtol=2e-3, err_msg=name)
    for name in DYNAMICS:
        np.testing.assert_allclose(rows[0][name], jrows[0][name], rtol=1e-3, err_msg=name)
    assert [r["loss"] for r in rows] == res["history"]
    assert res["final_metrics"] == {k: v for k, v in rows[-1].items() if k != "step"}


@pytest.mark.parametrize("package", [SUM, JSUM], ids=["port", "reference"])
def test_either_summarize_reads_either_run_dir(both_runs, package):
    jdir, tdir, _ = both_runs
    for d, version in ((jdir, "jax_version"), (tdir, "torch_version")):
        summary = package.summarize_run(d)
        assert summary["steps_logged"] == 4 and summary["algorithm"] == "dsm"
        assert summary["comm_ledger"]["degenerate_mesh"]
        assert {"train_window", "eval", "local_phase", "global_step"} <= set(summary["spans"])
        text = package.render(summary)
        assert "sign_agree" in text and "comm ledger" in text
        if package is SUM or version == "jax_version":
            assert f"{version}=" in text
    diff = SUM.diff(SUM.summarize_run(jdir), SUM.summarize_run(tdir))
    assert "jax_run" in diff and "torch_run" in diff and "loss" in diff


# ---------------------------------------------------------------------------
# Observability changes no number
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    {},
    dict(faults="drop=0.25,straggle=0.1,nan=0.2,seed=0", mask_nonfinite=True,
         guard_nonfinite=True),
    dict(algorithm="slowmo"),
], ids=["dsm", "dsm-faults-guards", "slowmo"])
def test_obs_and_sanitizers_change_no_number(tmp_path, extra):
    """History, every state tensor and the checkpoint files are bit-equal
    with and without the run directory, a profiled step and both
    sanitizers (the phase probe runs on a clone)."""
    def run(name, **obs):
        ck = str(tmp_path / f"ck_{name}")
        res = _run(TR.TrainSettings(checkpoint_dir=ck, checkpoint_every=2, **SMALL, **extra,
                                    **obs))
        files = {}
        for step in (0, 2, 4):
            data = np.load(CK.step_path(ck, step) + ".npz")
            files[step] = ({k: data[k] for k in data.files},
                           CK.load_meta(CK.step_path(ck, step))["extra"])
        return res, files

    plain, plain_files = run("plain")
    obs, obs_files = run("obs", run_dir=str(tmp_path / "run"), log_every=1,
                         profile_steps="1:2", sanitize=True, sanitize_nans=True)
    assert obs["history"] == plain["history"]
    for a, b in zip(G.state_tensors(obs["state"]), G.state_tensors(plain["state"])):
        assert torch.equal(a, b)
    for step, (arrays, meta) in plain_files.items():
        other, other_meta = obs_files[step]
        assert meta == other_meta
        for k, v in arrays.items():
            np.testing.assert_array_equal(other[k], v, err_msg=f"{step} {k}")
    assert plain["run_dir"] is None and plain["phase_ms"] is None
    assert obs["step_compiles"] is None and plain["step_compiles"] is None
    dsm = extra.get("algorithm", "dsm") == "dsm"
    assert (obs["probe_launches"] is not None) == dsm
    _, _, rows = OS.read_run(str(tmp_path / "run"))
    assert [r["loss"] for r in rows] == obs["history"]


# ---------------------------------------------------------------------------
# Guard counters, resume and rollback in the run directory
# ---------------------------------------------------------------------------

def test_guard_counters_survive_resume_as_the_reference_s(tmp_path):
    """The reference's scenario (spike factor ~0: every round after the
    first is rejected), with a run directory in both packages: equal
    skipped-round counts in the finished events, a resumed event, and the
    resumed run's rows appended."""
    common = dict(algorithm="dsm", n_workers=2, tau=2, b_micro=2, seq=32, eval_every=2,
                  guard_spike_factor=1e-6, guard_patience=100, checkpoint_every=2)
    finished = {}
    for name, mod, run in (("port", TR, lambda s: _run(s)),
                           ("ref", JTR, lambda s: JTR.run_training(J_NANO, s))):
        ck, rd = str(tmp_path / f"ck_{name}"), str(tmp_path / f"run_{name}")
        run(mod.TrainSettings(steps=4, checkpoint_dir=ck, run_dir=rd, **common))
        run(mod.TrainSettings(steps=8, resume=True, checkpoint_dir=ck, run_dir=rd, **common))
        _, events, rows = OS.read_run(rd)
        assert [e["step"] for e in events if e["kind"] == "resumed"] == [4]
        assert [r["step"] for r in rows] == list(range(1, 9))
        finished[name] = [(e["steps"], e["skipped_rounds"], e["rollbacks"])
                          for e in events if e["kind"] == "finished"]
    assert finished["port"] == finished["ref"] == [(4, 3, 0), (4, 7, 0)]


def test_rollback_relogged_steps_dedupe_to_the_accepted_row(tmp_path):
    """Checkpoints every round, spike factor 0.9, patience 2: each rollback
    re-logs rounds.  The flushed rejected rows stay in scalars.csv, and
    summarize's dedupe keeps the last row of each step: the final history."""
    s = TR.TrainSettings(guard_spike_factor=0.9, guard_patience=2, guard_max_rollbacks=4,
                         checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1,
                         run_dir=str(tmp_path / "run"), log_every=1,
                         **{**SMALL, "steps": 6, "eval_every": 6})
    res = _run(s)
    assert res["rollbacks"] > 0
    _, events, rows = OS.read_run(s.run_dir)
    assert len([e for e in events if e["kind"] == "rollback"]) == res["rollbacks"]
    assert len(rows) > s.steps
    deduped = SUM._dedupe_by_step(rows)
    assert [r["step"] for r in deduped] == list(range(1, s.steps + 1))
    assert [r["loss"] for r in deduped] == res["history"]
    fin = next(e for e in events if e["kind"] == "finished")
    assert (fin["skipped_rounds"], fin["rollbacks"]) == (res["skipped_rounds"], res["rollbacks"])


# ---------------------------------------------------------------------------
# Spans, the profile window and the trace reading
# ---------------------------------------------------------------------------

def test_profile_window_writes_a_trace_with_the_phase_ranges(tmp_path):
    s = TR.TrainSettings(run_dir=str(tmp_path), profile_steps="1:1", **SMALL)
    _run(s)
    traces = os.listdir(tmp_path / "profile")
    assert traces == ["outer_steps_1-1.pt.trace.json"]
    path = str(tmp_path / "profile" / traces[0])
    with open(path) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count("dsm_local_phase") == 1 and names.count("dsm_global_step") == 1
    summary = TRC.profile_summary(path)
    assert summary["busy_share"] is None and summary["device_events"] == 0   # CPU trace
    _, events, _ = OS.read_run(str(tmp_path))
    assert not [e for e in events if e["kind"] == "profile_failed"]


def test_a_failed_profiler_is_an_event_not_the_end_of_the_run(tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    res = _run(TR.TrainSettings(run_dir=str(tmp_path), profile_steps="0:1", **SMALL))
    _, events, _ = OS.read_run(str(tmp_path))
    failed = [e for e in events if e["kind"] == "profile_failed"]
    assert len(failed) == 1 and failed[0]["step"] == 0
    assert failed[0]["error"] == "RuntimeError: profiler unavailable"
    assert len(res["history"]) == SMALL["steps"]


def test_profile_summary_of_a_device_timeline(tmp_path):
    """A hand-made trace: the window opens at dsm_local_phase (t = 10) and
    ends with the last device activity (t = 60); the device is busy over
    [12, 20] u [18, 30] u [40, 60] = 38 of 50 us."""
    def x(cat, name, ts, dur, **kw):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, **kw}

    events = [x("user_annotation", "dsm_local_phase", 10, 25),
              x("user_annotation", "dsm_global_step", 35, 30),
              x("cpu_op", "aten::mm", 31, 8), x("cpu_op", "aten::add", 32, 2),
              x("kernel", "void adamw_kernel<bf16>(...)", 12, 8),
              x("kernel", "void adamw_kernel<bf16>(...)", 18, 12),
              x("gpu_memcpy", "Memcpy DtoH", 40, 5), x("kernel", "void dsm_kernel<bf16>", 45, 15),
              x("kernel", "early", 0, 5), {"ph": "i", "name": "marker", "ts": 1}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = TRC.profile_summary(str(path), top=2, gaps=5)
    assert got["kernel_launches"] == {"void adamw_kernel<bf16>(...)": 2,
                                      "void dsm_kernel<bf16>": 1, "early": 1}
    assert (got["window_us"], got["busy_us"]) == (50, 38)
    assert got["busy_share"] == 38 / 50
    assert [o["name"] for o in got["top_ops"]] == ["void adamw_kernel<bf16>(...)",
                                                    "void dsm_kernel<bf16>"]
    assert got["top_ops"][0]["us"] == 20 and got["top_ops"][0]["count"] == 2
    assert [(g["start_us"], g["us"]) for g in got["idle_gaps"]] == [(20, 10), (0, 2)]
    assert got["idle_gaps"][0]["host"] == "aten::mm"
    assert got["idle_gaps"][0]["host_ops"] == ["aten::mm", "aten::add"]


def test_tracing_primitives_match_reference():
    for mod in (TRC, JTRC):
        assert mod.parse_profile_steps(None) is None
        assert mod.parse_profile_steps("3:7") == (3, 7)
    for bad in ("7:3", "x", "1:2:3", "-1:2"):
        with pytest.raises(ValueError) as theirs:
            JTRC.parse_profile_steps(bad)
        with pytest.raises(ValueError) as ours:
            TRC.parse_profile_steps(bad)
        assert str(ours.value) == str(theirs.value)
    ours, theirs = TRC.PhaseTotals(), JTRC.PhaseTotals()
    for tot in (ours, theirs):
        tot.add("train_window", 1.0, n=4)
        tot.add("train_window", 1.0, n=4)
        tot.add("eval", 0.5)
    assert ours.as_dict() == theirs.as_dict() and ours.ms_per("nope") is None
    with TRC.Span("s", "cpu") as sp:
        pass
    assert sp.seconds >= 0.0
    assert TRC.device_memory_stats("cpu") is None
    assert TRC.timeit_fenced(lambda: None, iters=3) >= 0.0


# ---------------------------------------------------------------------------
# Sanitizers
# ---------------------------------------------------------------------------

def test_debug_nans_passes_a_faulted_masked_run_and_names_a_leak(monkeypatch):
    res = _run(TR.TrainSettings(faults="drop=0.25,straggle=0.1,nan=0.3,seed=0",
                                mask_nonfinite=True, sanitize_nans=True, **SMALL))
    assert all(np.isfinite(res["history"]))
    build = TR.build_algorithm

    def leaky(*a, **k):
        init, step, ev, mult = build(*a, **k)

        def step_leaks(state, batch, rng, faults=None):
            state, metrics = step(state, batch, rng, faults)
            if state.t == 2:
                state.m[3] = float("nan")
            return state, metrics

        return init, step_leaks, ev, mult

    monkeypatch.setattr(TR, "build_algorithm", leaky)
    with pytest.raises(SAN.SanitizeError, match=r"state\.m after outer step 2"):
        _run(TR.TrainSettings(sanitize_nans=True, **SMALL))
    assert issubclass(SAN.SanitizeError, RuntimeError)


# ---------------------------------------------------------------------------
# CLI and launcher
# ---------------------------------------------------------------------------

def _summarize(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.obs", "summarize", *args],
                          capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)


def test_summarize_cli(tmp_path, capsys):
    from repro_torch.launch import train as launch

    run_dir = str(tmp_path / "cli_run")
    launch.main(["--device", "cpu", "--steps", "2", "--n-workers", "2", "--tau", "2",
                 "--seq", "32", "--b-micro", "2", "--run-dir", run_dir, "--log-every", "1"])
    assert f"run dir: {run_dir} (summarize: python -m repro_torch.obs summarize {run_dir})" \
        in capsys.readouterr().out
    proc = _summarize(run_dir)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for section in ("metric", "sign_agree", "phase", "comm ledger", "throughput"):
        assert section in proc.stdout
    proc = _summarize(run_dir, "--json")
    assert proc.returncode == 0 and json.loads(proc.stdout)["steps_logged"] == 2
    proc = _summarize(run_dir, run_dir)
    assert proc.returncode == 0 and proc.stdout.startswith("diff")
    proc = _summarize(run_dir + "_nope")
    assert proc.returncode == 2 and "not a run directory" in proc.stderr


def test_launcher_flags_have_the_reference_defaults():
    from repro_torch.launch import train as launch

    args = launch.build_parser().parse_args([])
    assert (args.run_dir, args.log_every, args.profile_steps, args.sanitize,
            args.sanitize_nans) == (None, 0, None, False, False)
    s = TR.TrainSettings()
    j = JTR.TrainSettings()
    for f in ("run_dir", "log_every", "profile_steps", "sanitize", "sanitize_nans"):
        assert getattr(s, f) == getattr(j, f), f
