"""The port's native host-runtime binding (qm_control_tpu_torch.native)
against the cases of tests/test_native.py: seqlock policy buffer, delay
line, rate pacer, real-time priority, and a ThreadSanitizer soak of the
port's own copy of the C++ source. g++ builds the library on first use.

Also: the copy is byte-identical to native/qm_native.cpp, and a failed
build raises with the compiler's output (nothing falls back).
Tolerances: the buffer and the delay line are exact; the pacer's 50
periods at 200 Hz within 0.2-0.6 s, as tests/test_native.py allows.
"""
import filecmp
import os
import shutil
import subprocess
import threading
import time

import numpy as np
import pytest

from qm_control_tpu_torch import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_source_is_a_byte_identical_copy():
    assert filecmp.cmp(os.path.join(ROOT, "native", "qm_native.cpp"),
                       native._SRC, shallow=False)
    assert native.build().startswith(native.BUILD_DIR)


def test_policy_buffer_roundtrip():
    pb = native.PolicyBuffer(64)
    assert pb.read() is None
    data = np.arange(64, dtype=np.float32)
    pb.write(data, stamp=1.5)
    out, stamp = pb.read()
    np.testing.assert_array_equal(out, data)
    assert stamp == 1.5
    assert pb.version == 1
    with pytest.raises(ValueError):
        pb.write(np.zeros(63, np.float32))


def test_policy_buffer_concurrent_consistency():
    """The writer spins at full speed; every read is a consistent
    snapshot (all elements equal — a torn read would mix values)."""
    n = 1024
    pb = native.PolicyBuffer(n)
    stop = threading.Event()

    def writer():
        i = 0
        while not stop.is_set():
            pb.write(np.full(n, float(i % 1000), dtype=np.float32),
                     stamp=float(i))
            i += 1

    th = threading.Thread(target=writer, daemon=True)
    th.start()
    try:
        deadline = time.time() + 2.0
        reads = 0
        while time.time() < deadline:
            res = pb.read()
            if res is None:
                continue
            arr, _ = res
            assert (arr == arr[0]).all(), "torn read!"
            reads += 1
        assert reads > 100
    finally:
        stop.set()
        th.join(timeout=2)


@pytest.mark.parametrize("delay,expect", [(1.25, 4), (0.0, 9), (100.0, 0)],
                         ids=["delayed", "newest", "oldest-held"])
def test_delay_line_replays_old_records(delay, expect):
    dl = native.DelayLine(4, capacity=32)
    assert dl.read(0.0, 0.0) is None
    # binary-exact stamps (i * 0.25) avoid float boundary ambiguity
    for i in range(10):
        dl.push(i * 0.25, np.full(4, i, dtype=np.float32))
    np.testing.assert_array_equal(dl.read(2.25, delay),
                                  np.full(4, expect, dtype=np.float32))


def test_rate_pacer_paces():
    p = native.RatePacer(200.0)
    t0 = time.perf_counter()
    for _ in range(50):
        p.sleep()
    elapsed = time.perf_counter() - t0
    # 50 periods at 200 Hz = 0.25 s (generous jitter, as test_native.py)
    assert 0.2 < elapsed < 0.6, elapsed


def test_rate_pacer_counts_overruns():
    p = native.RatePacer(1000.0)
    time.sleep(0.05)     # miss ~50 periods
    missed = p.sleep()
    assert missed >= 10
    assert p.overruns >= missed


def test_set_realtime_priority_no_crash():
    # may be refused without privileges; must not raise either way
    res = []
    th = threading.Thread(target=lambda: res.append(
        native.set_realtime_priority(50)))
    th.start()
    th.join()
    assert res[0] in (True, False)


def test_failed_build_raises(monkeypatch, tmp_path):
    """No fallback: a source that does not compile raises with g++'s
    output, and nothing is left in the build directory."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert os.listdir(tmp_path / "build") == []


def test_tsan_soak(tmp_path):
    """ThreadSanitizer soak of the seqlock PolicyBuffer in the port's
    copy of the source: native/tsan_soak.cpp (a writer and two readers)
    compiled beside csrc/qm_native.cpp with -fsanitize=thread; no torn
    snapshot escapes the seqlock and no TSan report fires (exit code
    66), with native/tsan_suppressions.txt's benign payload copies."""
    gxx = shutil.which("g++")
    assert gxx is not None, "g++ builds the native library"
    shutil.copy(native._SRC, tmp_path / "qm_native.cpp")
    shutil.copy(os.path.join(ROOT, "native", "tsan_soak.cpp"), tmp_path)
    exe = str(tmp_path / "tsan_soak")
    build = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-g", "-fsanitize=thread", "-pthread",
         "-o", exe, "tsan_soak.cpp"], cwd=tmp_path, capture_output=True,
        text=True, timeout=300)
    if build.returncode != 0 and "fsanitize=thread" in build.stderr:
        pytest.skip("toolchain lacks the TSan runtime")
    assert build.returncode == 0, build.stderr[-2000:]
    env = dict(os.environ)
    env["TSAN_OPTIONS"] = ("suppressions=" + os.path.join(
        ROOT, "native", "tsan_suppressions.txt") + " exitcode=66")
    run = subprocess.run([exe], env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode != 66, "TSan report:\n" + run.stderr[-3000:]
    assert run.returncode == 0, run.stdout + run.stderr[-2000:]
    assert "OK" in run.stdout
