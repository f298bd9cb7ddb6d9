"""``ops/_build.py`` across threads: four threads that reach cold kernels
together compile each source once and load one library, and no two
compiles share a temp file. ``_nvcc`` is a stand-in script that writes
its ``-o`` file after a pause (the window two ``nvcc``s would race in)
and logs each call; ``ctypes.CDLL`` is a stand-in that counts loads.
Then ``ops/gru.py``'s launch plumbing under threads: each library's
launcher is typed once, and ``launches`` loses no count.
"""

import os
import stat
import sys
import threading
import types

import pytest
import torch

from deepspeech_tpu_torch.ops import _build, gru

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

FAKE_NVCC = """#!{python}
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open({log!r}, "a") as f:
    f.write(args[-1] + " " + out + "\\n")
time.sleep(0.3)
with open(out, "w") as f:
    f.write("built")
"""


class FakeCDLL:
    loads = []

    def __init__(self, path):
        FakeCDLL.loads.append(path)
        self.path = path


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeCDLL)
    FakeCDLL.loads = []
    return log


def _together(fn, n=4):
    """Run ``fn(k)`` on ``n`` threads released at once; returns their
    results (re-raising the first error)."""
    barrier = threading.Barrier(n)
    results, errors = [None] * n, []

    def run(k):
        barrier.wait()
        try:
            results[k] = fn(k)
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "a build thread did not finish"
    if errors:
        raise errors[0]
    return results


def _calls(log):
    return [line.split() for line in log.read_text().splitlines()]


def test_threads_load_one_library(fake_toolchain):
    libs = _together(lambda k: _build.load("gru_fwd"))
    calls = _calls(fake_toolchain)
    assert [os.path.basename(src) for src, _ in calls] == ["gru_fwd.cu"]
    assert all(lib is libs[0] for lib in libs)
    assert FakeCDLL.loads == [_build._target("gru_fwd")]
    assert os.path.exists(_build._target("gru_fwd"))


def test_threads_build_and_load_each_source_once(fake_toolchain):
    names = ["gru_fwd", "gru_fwd_q", "ctc"]

    def work(k):
        paths = _build.build(names)
        return paths, _build.load(names[k % len(names)])

    results = _together(work)
    calls = _calls(fake_toolchain)
    assert sorted(os.path.basename(src) for src, _ in calls) == \
        sorted(f"{n}.cu" for n in names)
    # Each compile wrote a temp name of its own, tagged with the process
    # and the thread, and every temp was renamed into place.
    temps = [tmp for _, tmp in calls]
    assert len(set(temps)) == len(temps)
    assert all(f".{os.getpid()}." in tmp for tmp in temps)
    assert not any(f.endswith(".tmp") for f in os.listdir(_build.BUILD_DIR))
    assert all(paths == results[0][0] for paths, _ in results)
    assert sorted(FakeCDLL.loads) == sorted(
        {_build._target(names[k % len(names)]) for k in range(4)})
    for paths, lib in results:
        assert lib is _build._loaded[os.path.basename(lib.path)[3:].split(
            "-")[0]]


class _TypedFunc:
    """A ctypes function stand-in that counts its typings."""

    def __init__(self, log):
        self.log = log
        self._argtypes = None
        self.restype = None

    @property
    def argtypes(self):
        return self._argtypes

    @argtypes.setter
    def argtypes(self, value):
        self.log.append(len(value))
        self._argtypes = value


class _FakeLib:
    """A loaded library stand-in: ``lib.f`` is one cached function a
    name, ``lib["f"]`` a new one each time, as ``ctypes.CDLL`` does."""

    def __init__(self):
        self.typings = []
        self._attrs = {}

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self._attrs.setdefault(name, _TypedFunc(self.typings))

    def __getitem__(self, name):
        return _TypedFunc(self.typings)


def test_launcher_typed_once_across_threads(monkeypatch):
    """Eight threads asking for the same launcher get one function, typed
    once; another pointer count types a function of its own."""
    lib = _FakeLib()
    monkeypatch.setattr(gru._build, "load", lambda name: lib)
    got = _together(lambda k: gru._launcher("gru_fwd", 5), n=8)
    assert all(fn is got[0][1] for _, fn in got)
    # The error-string function and one launcher (1 + 3 + 5 pointers +
    # 6 ints + the stream): two typings.
    assert lib.typings == [1, 11 + 5]
    _, other = gru._launcher("gru_fwd", 4)
    assert other is not got[0][1] and lib.typings[-1] == 11 + 4
    assert gru._launcher("gru_fwd", 5)[1] is got[0][1]


def test_launch_counts_lose_nothing_across_threads():
    """Eight threads counting 2000 launches each, with the interpreter
    switching threads as often as it can: no count is lost."""
    fn = types.SimpleNamespace(launches=0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _together(lambda k: [gru._counted(fn) for _ in range(2000)], n=8)
    finally:
        sys.setswitchinterval(interval)
    assert fn.launches == 8 * 2000


CHILD = """
import sys, time
from deepspeech_tpu_torch.ops import _build
_build._nvcc = lambda: {nvcc!r}
_build.BUILD_DIR = {build!r}
while time.time() < {start!r}:
    time.sleep(0.005)
print(_build.build(["gru_fwd"])["gru_fwd"])
"""


def test_processes_build_one_source_once(tmp_path):
    """Three processes that reach a cold kernel at the same moment: the
    build directory's file lock lets one compile it, and the others
    wait and load that library (one ``nvcc`` call in the log)."""
    import subprocess
    import time

    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    code = CHILD.format(nvcc=str(nvcc), build=str(tmp_path / "build"),
                        start=time.time() + 8.0)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=root,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1 and os.path.exists(paths.pop())
    assert len(log.read_text().splitlines()) == 1
