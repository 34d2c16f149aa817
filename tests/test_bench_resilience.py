"""The driver-capture contract of bench.py: ONE parseable JSON line on
stdout and rc=0 in EVERY exit path — normal completion, induced hard
deadline, SIGTERM (the driver's `timeout` sends TERM first).

A run that is cut by its caller's timeout must still leave one parseable
line, and a CPU run must shrink to a liveness-sized workload. These tests
keep both true.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench.py")
REPO = os.path.dirname(BENCH)


def _env(**extra):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _parse_single_json_line(stdout: str) -> dict:
    lines = [ln for ln in stdout.strip().splitlines() if ln.strip()]
    assert len(lines) == 1, f"expected exactly one stdout line, got {lines!r}"
    return json.loads(lines[0])


def test_lean_cpu_run_completes_with_single_line():
    proc = subprocess.run(
        [sys.executable, BENCH],
        env=_env(BENCH_DOCS=3000, BENCH_EXACT_QUERIES=8),
        capture_output=True, text=True, timeout=240, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = _parse_single_json_line(proc.stdout)
    assert out["detail"]["partial"] is False
    assert out["detail"]["lean"] is True  # cpu backend without BENCH_FULL_CPU
    assert out["value"] > 0
    assert "exact_engine" in out["detail"]["completed_sections"]


def test_hard_deadline_emits_partial_line():
    # a 2s ceiling fires during corpus/index build — before any section —
    # and must still produce a parseable line with rc=0
    proc = subprocess.run(
        [sys.executable, BENCH],
        env=_env(BENCH_DOCS=60000, BENCH_FULL_CPU=1, BENCH_HARD_S=2),
        capture_output=True, text=True, timeout=240, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = _parse_single_json_line(proc.stdout)
    assert out["detail"]["partial"] is True
    assert "hard deadline" in proc.stderr


def test_sigterm_emits_partial_line():
    p = subprocess.Popen(
        [sys.executable, BENCH],
        env=_env(BENCH_DOCS=30000, BENCH_FULL_CPU=1, BENCH_EXACT_QUERIES=32),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO,
    )
    try:
        deadline = time.time() + 180
        seen = b""
        # wait for the first measured section, then TERM mid-run
        os.set_blocking(p.stderr.fileno(), False)
        while time.time() < deadline:
            chunk = p.stderr.read()
            if chunk:
                seen += chunk
            if b"exact batched" in seen:
                break
            if p.poll() is not None:
                pytest.fail(f"bench exited early: {seen[-2000:]!r}")
            time.sleep(0.5)
        else:
            pytest.fail("never reached the exact section")
        p.send_signal(signal.SIGTERM)
        stdout, stderr = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode == 0, (seen + stderr)[-2000:]
    out = _parse_single_json_line(stdout.decode())
    assert out["detail"]["partial"] is True
    assert out["value"] > 0  # the exact section had completed
