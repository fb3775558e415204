"""Unit tests for the bench.py parent/child harness.

The parent runs one child at a time under a total deadline, walks the
solver-fallback chain on crashes, and reports the last metric line a child
banked.  These tests exercise the parent's process plumbing with a fake
``subprocess.Popen`` — no accelerator, no real children.
"""

import json
import subprocess
import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench


METRIC = json.dumps({"metric": "m", "value": 1.0, "unit": "s",
                     "vs_baseline": 2.0})


class FakeProc:
    """Stands in for subprocess.Popen: scripted stdout / rc / timeout."""

    def __init__(self, stdout="", rc=0, hang=False):
        self._stdout = stdout
        self.returncode = rc
        self._hang = hang
        self.killed = False
        self.pid = 12345

    def communicate(self, timeout=None):
        if self._hang and not self.killed:
            raise subprocess.TimeoutExpired(cmd="fake", timeout=timeout)
        return self._stdout, None

    def kill(self):
        self.killed = True
        self.returncode = -9


def _patch_popen(monkeypatch, procs, envs_seen):
    it = iter(procs)

    def fake_popen(cmd, stdout=None, stderr=None, text=None, env=None,
                   cwd=None):
        envs_seen.append(env)
        return next(it)

    monkeypatch.setattr(bench.subprocess, "Popen", fake_popen)
    monkeypatch.setattr(bench.time, "sleep", lambda s: None)


def test_attempt_plan_flagship_fallback_chain():
    plan = bench._attempt_plan("elasticity3d")
    solvers = [env.get("PDE_BENCH_SOLVER") for env, _ in plan]
    assert solvers == ["df2", "df", "mgf32"]
    assert all(t > 0 for _, t in plan)


def test_attempt_plan_bar1d_runs_on_cpu_backend():
    plan = bench._attempt_plan("bar1d")
    for env, _ in plan:
        assert env.get("JAX_PLATFORMS") == "cpu"


def test_parent_first_attempt_success(monkeypatch, capsys):
    envs = []
    _patch_popen(monkeypatch, [
        FakeProc(stdout="noise line\n" + METRIC + "\n", rc=0),
    ], envs)
    monkeypatch.setenv("PDE_BENCH_CONFIG", "elasticity3d")
    assert bench.run_parent() == 0
    out_lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert out_lines == [METRIC]
    assert envs[0]["PDE_BENCH_CHILD"] == "1"
    assert envs[0]["PDE_BENCH_SOLVER"] == "df2"


def test_parent_crash_then_fallback_solver(monkeypatch, capsys):
    envs = []
    _patch_popen(monkeypatch, [
        FakeProc(stdout="Traceback ...\n", rc=1),         # df2 child dies
        FakeProc(stdout=METRIC + "\n", rc=0),             # df child succeeds
    ], envs)
    monkeypatch.setenv("PDE_BENCH_CONFIG", "elasticity3d")
    assert bench.run_parent() == 0
    assert capsys.readouterr().out.strip() == METRIC
    assert [e["PDE_BENCH_SOLVER"] for e in envs] == ["df2", "df"]


def test_parent_timeout_kills_child_and_falls_back(monkeypatch, capsys):
    hung = FakeProc(stdout="", hang=True)
    envs = []
    _patch_popen(monkeypatch, [hung, FakeProc(stdout=METRIC + "\n")], envs)
    monkeypatch.setenv("PDE_BENCH_CONFIG", "elasticity3d")
    assert bench.run_parent() == 0
    assert hung.killed
    assert capsys.readouterr().out.strip() == METRIC


def test_parent_all_attempts_fail_rc1_no_json(monkeypatch, capsys):
    envs = []
    _patch_popen(monkeypatch, [FakeProc(rc=1) for _ in range(3)], envs)
    monkeypatch.setenv("PDE_BENCH_CONFIG", "elasticity3d")
    assert bench.run_parent() == 1
    assert capsys.readouterr().out.strip() == ""
    assert len(envs) == 3  # walked the whole chain


def test_parent_ignores_non_metric_json(monkeypatch, capsys):
    decoy = json.dumps({"status": "warming"})
    envs = []
    _patch_popen(monkeypatch, [
        FakeProc(stdout=decoy + "\n", rc=0),
        FakeProc(stdout=decoy + "\n" + METRIC + "\n", rc=0),
    ], envs)
    monkeypatch.setenv("PDE_BENCH_CONFIG", "elasticity3d")
    assert bench.run_parent() == 0
    assert capsys.readouterr().out.strip() == METRIC


def test_parent_keeps_banked_metric_from_killed_child(monkeypatch, capsys):
    """Round-4 contract (VERDICT r3 item 1): a child killed on timeout may
    already have banked a metric line — the parent must emit it rather than
    report failure."""
    hung_with_bank = FakeProc(stdout="noise\n" + METRIC + "\n", hang=True)
    envs = []
    _patch_popen(monkeypatch, [
        hung_with_bank,
        FakeProc(stdout="Traceback ...\n", rc=1),
        FakeProc(stdout="Traceback ...\n", rc=1),
    ], envs)
    monkeypatch.setenv("PDE_BENCH_CONFIG", "elasticity3d")
    assert bench.run_parent() == 0
    assert hung_with_bank.killed
    assert capsys.readouterr().out.strip() == METRIC


def test_parent_last_banked_line_wins(monkeypatch, capsys):
    """The child emits provisional lines then upgrades them; the parent must
    report the LAST metric line of a child's stdout."""
    provisional = json.dumps({"metric": "m", "value": 200.0, "unit": "s",
                              "provisional": "warmup_includes_jit_compile"})
    envs = []
    _patch_popen(monkeypatch, [
        FakeProc(stdout=provisional + "\n" + METRIC + "\n", rc=0),
    ], envs)
    monkeypatch.setenv("PDE_BENCH_CONFIG", "elasticity3d")
    assert bench.run_parent() == 0
    assert capsys.readouterr().out.strip() == METRIC


def test_parent_respects_deadline(monkeypatch, capsys):
    """With the budget (almost) spent, the parent must not spawn children
    that the driver would kill anyway."""
    envs = []
    _patch_popen(monkeypatch, [FakeProc(stdout=METRIC + "\n")], envs)
    monkeypatch.setenv("PDE_BENCH_CONFIG", "elasticity3d")
    monkeypatch.setenv("PDE_BENCH_DEADLINE", "100")  # < 150s floor
    assert bench.run_parent() == 1
    assert envs == []
    assert capsys.readouterr().out.strip() == ""


def test_parent_attempt_timeouts_fit_deadline(monkeypatch, capsys):
    """Every attempt timeout must fit inside what is left of the deadline
    (the r03 failure: attempt 1 alone exceeded the driver window)."""
    envs = []
    procs = [FakeProc(stdout="", rc=1) for _ in range(3)]
    _patch_popen(monkeypatch, procs, envs)

    timeouts = []
    real_comm = FakeProc.communicate

    def spy_comm(self, timeout=None):
        timeouts.append(timeout)
        return real_comm(self, timeout=timeout)

    monkeypatch.setattr(FakeProc, "communicate", spy_comm)
    monkeypatch.setenv("PDE_BENCH_CONFIG", "elasticity3d")
    monkeypatch.setenv("PDE_BENCH_DEADLINE", "1380")
    assert bench.run_parent() == 1
    # crash-exits consume ~no wall time here, so each timeout must be
    # bounded by its plan cap and by deadline-40
    caps = [c for _, c in bench._attempt_plan("elasticity3d")]
    assert len(timeouts) == 3
    for t, cap in zip(timeouts, caps):
        assert t <= cap
        assert t <= 1380 - 40
    # the child budget env must accompany each spawn
    for e, t in zip(envs, timeouts):
        assert float(e["PDE_BENCH_CHILD_BUDGET"]) <= t


def test_child_time_left_unbounded_without_budget(monkeypatch):
    monkeypatch.delenv("PDE_BENCH_CHILD_BUDGET", raising=False)
    assert bench.child_time_left() == float("inf")
    monkeypatch.setenv("PDE_BENCH_CHILD_BUDGET", "1e9")
    assert bench.child_time_left() < 1e9
