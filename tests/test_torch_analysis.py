"""repro_torch.analysis: each rule fires on a known-bad snippet and stays
quiet on the fixed one, suppressions downgrade findings without hiding
them, the numpy halves and the engine agree with ``repro.analysis`` on
the same snippets, the port's own packages are finding-free (the
self-hosting gate), and the sync census attributes and checks sites."""
import importlib.util
import json
import os
import pathlib
import warnings

import pytest
import torch

from repro.analysis import engine as ref_engine
from repro_torch.analysis import all_rules, analyze_paths, analyze_source, run_cli
from repro_torch.analysis.sync_census import SYNC_MESSAGE, SyncCensus

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _live(src, select=None):
    return [f for f in analyze_source(src, select=select) if not f.suppressed]


def _rules_of(findings):
    return {f.rule for f in findings}


# ---------------------------------------------------------------------------
# R001 host syncs on the hot path
# ---------------------------------------------------------------------------

BAD_R001 = """
import torch
from torch.profiler import record_function

def step(x: torch.Tensor):
    with record_function("dedup.step"):
        n = x.sum().item()
    return n
"""

BAD_R001_TRANSITIVE = """
import torch
from torch.profiler import record_function

def helper(x: torch.Tensor):
    return int(x[0]) + 1

def step(x: torch.Tensor):
    with record_function("dedup.step"):
        return helper(x)
"""

BAD_R001_KERNEL_ROOT = """
import ctypes
import torch
from .._build import Kernel, check_cuda, ptr

KERNEL = Kernel("k", "k.cu", "k_launch", [ctypes.c_void_p] * 2)

def launch(x: torch.Tensor):
    check_cuda("x", x, torch.int64)
    out = torch.empty_like(x)
    n = torch.nonzero(x > 0)
    KERNEL(ptr(x), ptr(out))
    return out, n
"""

BAD_R001_KINDS = """
import numpy as np
import torch
from torch.profiler import record_function

def step(x: torch.Tensor, rows: np.ndarray, device):
    with record_function("stream.level"):
        a = x.cpu()
        b = x[x > 0]
        c = torch.unique(x)
        d = torch.as_tensor(rows, device=device)
        e = torch.from_numpy(rows).to(device)
        f = x.repeat_interleave(x)
        torch.cuda.synchronize()
    return a, b, c, d, e, f
"""

GOOD_R001 = """
import numpy as np
import torch
from torch.profiler import record_function

def host_prep(x: torch.Tensor):
    return x.cpu().numpy()  # not on a hot path: fine

def step(x: torch.Tensor, n: int):
    with record_function("dedup.step"):
        y = x.repeat_interleave(2)
        z = torch.repeat_interleave(x, x, output_size=n)
        w = x[: x.shape[0] // 2]
        return (y.sum() + z.sum() + w.sum()).to("cuda", non_blocking=True)
"""


def test_r001_fires_on_item_in_a_range():
    findings = _live(BAD_R001, select=["R001"])
    assert _rules_of(findings) == {"R001"}
    assert any(".item()" in f.message for f in findings)


def test_r001_fires_through_the_call_graph():
    findings = _live(BAD_R001_TRANSITIVE, select=["R001"])
    assert [(f.rule, f.line) for f in findings] == [("R001", 6)]


def test_r001_roots_at_kernel_launches():
    findings = _live(BAD_R001_KERNEL_ROOT, select=["R001"])
    assert [f.line for f in findings] == [11]


def test_r001_flags_every_kind_of_sync():
    lines = [f.line for f in _live(BAD_R001_KINDS, select=["R001"])]
    assert lines == [8, 9, 10, 11, 12, 13, 14]


def test_r001_quiet_on_host_side_and_sized_ops():
    assert _live(GOOD_R001, select=["R001"]) == []


# ---------------------------------------------------------------------------
# R002 dtype-contract drift
# ---------------------------------------------------------------------------

BAD_R002_LITERAL = """
import numpy as np

def pack(w):
    w = np.uint64(w)
    return w + 3
"""

BAD_R002_NARROW = """
import numpy as np

def truncate(words):
    w = np.uint64(words)
    return w.astype(np.int32)
"""

BAD_R002_TORCH = """
import torch
from ..core import u64

def route(key64: torch.Tensor, words: torch.Tensor):
    hi = key64 >> 32
    first = torch.sort(words)
    small = key64 < words
    lo = key64.to(torch.int32)
    raw = key64.to(torch.uint64)
    k = u64.from_numpy_u64(None)
    m = torch.minimum(k, hi)
    return hi, first, small, lo, raw, m
"""

GOOD_R002 = """
import numpy as np
import torch
from ..core import u64

def pack(w):
    w = np.uint64(w)
    return w + np.uint64(3)

def low_bits(words):
    w = np.uint64(words)
    return (w & np.uint64(0xFFFF)).astype(np.int32)

def route(key64: torch.Tensor, words: torch.Tensor):
    hi = u64.shr(key64, 32)
    first = u64.sort(words)[0]
    small = u64.lt(key64, words)
    lo = u64.to_int32_bits(key64)
    n = words.numel() > 0
    return hi, first, small, lo, n, torch.sort(lo)
"""


def test_r002_fires_on_u64_literal_mix():
    assert _rules_of(_live(BAD_R002_LITERAL, select=["R002"])) == {"R002"}


def test_r002_fires_on_narrowing_cast():
    assert _rules_of(_live(BAD_R002_NARROW, select=["R002"])) == {"R002"}


def test_r002_fires_on_the_int64_u64_contract():
    findings = _live(BAD_R002_TORCH, select=["R002"])
    assert [f.line for f in findings] == [6, 7, 8, 9, 10, 12]


def test_r002_quiet_through_core_u64_and_masked_narrowing():
    assert _live(GOOD_R002, select=["R002"]) == []


def test_r002_torch_half_is_silent_inside_core_u64():
    assert [f for f in analyze_source(BAD_R002_TORCH, path="src/core/u64.py",
                                      select=["R002"])] == []


# ---------------------------------------------------------------------------
# R003 python control flow on tensors
# ---------------------------------------------------------------------------

BAD_R003 = """
import torch
from torch.profiler import record_function

def relu_or_neg(x: torch.Tensor):
    with record_function("dedup.relu"):
        if x.sum() > 0:
            return x
        assert (x < 0).all()
        return [v for v in (x, -x) if not v.any()]
"""

GOOD_R003 = """
import torch
import torch.distributed as dist
from torch.profiler import record_function

def relu_or_neg(x: torch.Tensor, mask=None, *, flip: bool = False):
    with record_function("dedup.relu"):
        if flip or mask is None:  # host values: fine
            x = -x
        if x.numel() and x.device.type == "cuda" and dist.get_rank() == 0:
            x = x * 2
        return torch.where(x > 0, x, -x)
"""


def test_r003_fires_on_tensor_branches():
    findings = _live(BAD_R003, select=["R003"])
    assert [f.line for f in findings] == [7, 9, 10]


def test_r003_quiet_on_host_branches_and_where():
    assert _live(GOOD_R003, select=["R003"]) == []


# ---------------------------------------------------------------------------
# R004 unsynced CUDA timing
# ---------------------------------------------------------------------------

BAD_R004 = """
import time
import torch

def bench(fn, x):
    t0 = time.perf_counter()
    out = fn(x)
    dt = time.perf_counter() - t0
    return out, dt
"""

GOOD_R004 = """
import time
import torch

def bench(fn, x):
    t0 = time.perf_counter()
    out = fn(x)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return out, dt

def bench_host(fn, x):
    t0 = time.perf_counter()
    out = fn(x).cpu()
    return out, time.perf_counter() - t0
"""


def test_r004_fires_on_unsynced_window():
    assert _rules_of(_live(BAD_R004, select=["R004"])) == {"R004"}


def test_r004_quiet_when_synchronized_or_downloaded():
    assert _live(GOOD_R004, select=["R004"]) == []


# ---------------------------------------------------------------------------
# R005: no counterpart
# ---------------------------------------------------------------------------


def test_r005_is_listed_without_a_check():
    rule = all_rules()["R005"]
    assert rule.check is None and "trace cache" in rule.description
    assert analyze_source(BAD_R001, select=["R005"]) == []


# ---------------------------------------------------------------------------
# engine mechanics: suppressions, syntax errors, CLI exit codes
# ---------------------------------------------------------------------------

SUPPRESSED = """
import torch
from torch.profiler import record_function

def step(x: torch.Tensor):
    with record_function("dedup.step"):
        return x.cpu()  # repro: noqa[R001] the host reads the rows back
"""


def test_noqa_downgrades_but_keeps_the_finding():
    findings = analyze_source(SUPPRESSED, select=["R001"])
    assert len(findings) == 1
    assert findings[0].suppressed


def test_noqa_for_a_different_rule_does_not_apply():
    src = SUPPRESSED.replace("noqa[R001]", "noqa[R004]")
    assert [f.suppressed for f in analyze_source(src, select=["R001"])] == [False]


def test_bare_noqa_suppresses_every_rule():
    src = SUPPRESSED.replace("noqa[R001] the host reads the rows back", "noqa")
    assert all(f.suppressed for f in analyze_source(src))


def test_noqa_on_first_line_covers_the_whole_statement():
    src = """
import torch
from torch.profiler import record_function

def step(x: torch.Tensor):
    with record_function("dedup.step"):
        y = (  # repro: noqa[R001]
            x.cpu())
    return y
"""
    findings = analyze_source(src, select=["R001"])
    assert len(findings) == 1 and findings[0].suppressed


def test_noqa_on_compound_header_does_not_blanket_the_body():
    src = """
import torch
from torch.profiler import record_function

def step(  # repro: noqa[R001]
    x: torch.Tensor,
):
    with record_function("dedup.step"):
        return x.cpu()
"""
    assert [f.suppressed for f in analyze_source(src, select=["R001"])] == [False]


def test_syntax_error_becomes_e999():
    findings = analyze_source("def f(:\n    pass\n")
    assert [f.rule for f in findings] == ["E999"]


def test_rule_pack_is_complete():
    rules = all_rules()
    assert set(rules) == {f"R00{i}" for i in range(1, 10)}
    assert [r for r, rule in rules.items() if rule.check is None] == ["R005"]
    assert all(rule.mirrors.startswith(r) for r, rule in rules.items())


def test_list_rules_names_counterparts_and_the_one_without(capsys):
    assert run_cli(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for r in ("R001", "R002", "R003", "R004", "R006", "R007", "R008", "R009"):
        assert f"{r}  " in out and f"counterpart of repro.analysis {r}" in out
    assert "R005  no counterpart of repro.analysis R005 jit-cache-hazard" in out


def test_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(BAD_R001)
    good = tmp_path / "good.py"
    good.write_text(GOOD_R001)
    assert run_cli([str(good), "--no-cache"]) == 0
    assert run_cli([str(bad), "--no-cache"]) == 1
    assert "R001" in capsys.readouterr().out
    assert run_cli([str(bad), "--no-cache", "--select", "R004"]) == 0


def test_cli_github_format_emits_annotations(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(BAD_R001)
    assert run_cli([str(bad), "--no-cache", "--format", "github"]) == 1
    out = capsys.readouterr().out
    assert "::error file=" in out and "R001" in out


def test_cli_warn_only_reports_but_exits_zero(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(BAD_R001)
    assert run_cli([str(bad), "--no-cache", "--warn-only", "--format", "github"]) == 0
    assert "::warning file=" in capsys.readouterr().out


def test_cli_json_format_and_report(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(BAD_R001)
    report = tmp_path / "report.json"
    assert run_cli([str(bad), "--no-cache", "--format", "json",
                    "--report", str(report)]) == 1
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(report.read_text())
    assert any(f["rule"] == "R001" for f in printed)


def test_cli_default_cache_is_not_the_reference_pass(tmp_path, monkeypatch):
    bad = tmp_path / "bad.py"
    bad.write_text(BAD_R001)
    monkeypatch.chdir(tmp_path)
    assert run_cli([str(bad)]) == 1
    assert (tmp_path / ".repro-torch-analysis.cache.json").exists()
    assert not (tmp_path / ".repro-analysis.cache.json").exists()


# ---------------------------------------------------------------------------
# R006 collective contracts (mesh-dim universe + all_to_all_single splits)
# ---------------------------------------------------------------------------

GOOD_R006 = """
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

mesh = init_device_mesh("cuda", (4,), mesh_dim_names=("data",))

def exchange(x, mesh=mesh):
    y = x.reshape(8, 128)
    out = torch.empty_like(y)
    dist.all_to_all_single(out, y, group=mesh.get_group("data"))
    return out, mesh["data"], mesh.size("data")
"""


@pytest.mark.parametrize("edit,what", [
    ('mesh["data"]', "mesh dim `model`"),
    ('mesh.size("data")', "`size` over mesh dim `model`"),
    ('x.reshape(8, 128)', "extent 6 is not divisible"),
    ('group=mesh.get_group("data")', "split sizes [1, 1] name 2 shards"),
])
def test_r006_fires_on_contract_breaks(edit, what):
    bad = {'mesh["data"]': 'mesh["model"]', 'mesh.size("data")': 'mesh.size("model")',
           'x.reshape(8, 128)': 'x.reshape(6, 128)',
           'group=mesh.get_group("data")':
               'group=mesh.get_group("data"), input_split_sizes=[1, 1]'}[edit]
    findings = _live(GOOD_R006.replace(edit, bad), select=["R006"])
    assert _rules_of(findings) == {"R006"}
    assert any(what in f.message for f in findings), [f.message for f in findings]


def test_r006_quiet_on_declared_dims_and_dividing_split():
    assert _live(GOOD_R006, select=["R006"]) == []


def test_r006_quiet_without_any_mesh_declaration():
    src = "def f(mesh):\n    return mesh.get_group('model')\n"
    assert _live(src, select=["R006"]) == []


# ---------------------------------------------------------------------------
# R007 padding / sentinel contracts
# ---------------------------------------------------------------------------

BAD_R007_PAD = """
import numpy as np

def mean_rows(x, n_real: int):
    padded = np.pad(x, ((0, 8), (0, 0)))
    return np.mean(padded)
"""

BAD_R007_SENTINEL = """
import numpy as np

def decode(keys):
    words = np.full((4, 16), np.uint32(0xFFFFFFFF))
    words[: len(keys)] = keys
    return unpack_words_host(words)
"""

GOOD_R007 = """
import numpy as np

def mean_rows(x, n_real: int):
    padded = np.pad(x, ((0, 8), (0, 0)))
    return np.mean(padded[:n_real])

def decode(keys, words):
    live = words[words != np.uint32(0xFFFFFFFF)]
    return unpack_words_host(live)
"""

R007_TAINT = """
import numpy as np

def histogram(x):
    padded = np.pad(x, (0, 8))
    counts = launch_kernel(padded)
    return np.cumsum(counts)
"""

BAD_R007_TORCH = """
import torch
import torch.nn.functional as F
from ..core import u64

def count(x, n_real: int):
    padded = F.pad(x, (0, 8))
    rows = pad_probe_rows(x, 64)
    return padded.sum(), torch.bincount(rows)

def decode(n):
    words = torch.full((n,), -1)
    keys = u64.full((n,), u64.SENTINEL)
    return unpack_words(words), unpack_key64(keys)
"""

GOOD_R007_TORCH = """
import torch
import torch.nn.functional as F

def count(x, n_real: int, valid):
    padded = F.pad(x, (0, 8))
    return padded[:n_real].sum(), torch.where(valid, padded, 0).any()

def decode(n, live):
    words = torch.full((n,), -1)
    return unpack_words(words[live])
"""


def test_r007_fires_on_reduction_over_padded():
    findings = _live(BAD_R007_PAD, select=["R007"])
    assert _rules_of(findings) == {"R007"} and any("mean" in f.message for f in findings)


def test_r007_fires_on_unfiltered_sentinel_unpack():
    findings = _live(BAD_R007_SENTINEL, select=["R007"])
    assert _rules_of(findings) == {"R007"} and any("sentinel" in f.message for f in findings)


def test_r007_fires_on_torch_pads_and_sentinels():
    assert [f.line for f in _live(BAD_R007_TORCH, select=["R007"])] == [9, 9, 14, 14]


def test_r007_quiet_on_sliced_and_filtered_uses():
    assert _live(GOOD_R007, select=["R007"]) == []
    assert _live(GOOD_R007_TORCH, select=["R007"]) == []


def test_r007_taint_does_not_cross_arbitrary_calls():
    assert _live(R007_TAINT, select=["R007"]) == []


# ---------------------------------------------------------------------------
# R008 serving concurrency
# ---------------------------------------------------------------------------

BAD_R008_BLOCKING = """
import time

class Lane:
    def drain(self):
        with self._lock:
            time.sleep(0.01)
            self.flushed += 1
"""

BAD_R008_UNGUARDED = """
class Metrics:
    def __init__(self):
        self.served = 0

    def record(self):
        with self._lock:
            self.served += 1

    def record_fast(self):
        self.served += 1
"""

GOOD_R008 = """
import time

class Lane:
    def __init__(self):
        self.flushed = 0

    def drain(self):
        batch = self.q.get()
        with self._lock:
            self.flushed += 1
        time.sleep(0.01)

    def report(self):
        with self._lock:
            self.flushed += 1
"""

BAD_R008_SYNC = """
import torch

class Lane:
    def drain(self):
        with self._lock:
            torch.cuda.synchronize()
"""


def test_r008_fires_on_blocking_call_under_lock():
    for src in (BAD_R008_BLOCKING, BAD_R008_SYNC):
        findings = _live(src, select=["R008"])
        assert _rules_of(findings) == {"R008"}
        assert any("blocking" in f.message for f in findings)


def test_r008_fires_on_inconsistently_guarded_attribute():
    findings = _live(BAD_R008_UNGUARDED, select=["R008"])
    assert _rules_of(findings) == {"R008"}
    assert any("record_fast" in f.message for f in findings)


def test_r008_quiet_on_consistent_locking():
    assert _live(GOOD_R008, select=["R008"]) == []


# ---------------------------------------------------------------------------
# R009 kernel launch contract
# ---------------------------------------------------------------------------

GOOD_R009 = """
import ctypes
import torch
from .._build import Kernel, check_cuda, ptr

KERNEL = Kernel("k", "k.cu", "k_launch", [ctypes.c_void_p] * 3 + [ctypes.c_longlong])
PAIR = Kernel("p", "k.cu", "p_launch", [ctypes.c_void_p, ctypes.c_void_p])

def _check_words(words):
    check_cuda("words", words, torch.int64)

def launch(a: torch.Tensor, b: torch.Tensor):
    check_cuda("a", a, torch.int64)
    _check_words(b)
    out = torch.empty_like(a)
    KERNEL(ptr(a), ptr(b), ptr(out), a.numel())
    return out

def launch_many(x, y):
    for name, t, dtype in (("x", x, torch.int32), ("y", y, torch.uint8)):
        check_cuda(name, t, dtype)
    PAIR(ptr(x), ptr(y))
"""


@pytest.mark.parametrize("edit,bad,what", [
    ("ptr(out), a.numel())", "ptr(out))", "3 arguments, its argtypes declare 4"),
    ("    _check_words(b)\n", "", "`ptr(b)`"),
    ('(("x", x, torch.int32), ', "(", "`ptr(x)`"),
])
def test_r009_fires_on_launch_contract_breaks(edit, bad, what):
    findings = _live(GOOD_R009.replace(edit, bad), select=["R009"])
    assert _rules_of(findings) == {"R009"}
    assert any(what in f.message for f in findings), [f.message for f in findings]


def test_r009_quiet_on_checked_and_allocated_pointers():
    assert _live(GOOD_R009, select=["R009"]) == []


# ---------------------------------------------------------------------------
# parity with repro.analysis on the numpy halves and the engine
# ---------------------------------------------------------------------------

PARITY_SNIPPETS = {
    "r002-literal": BAD_R002_LITERAL,
    "r002-narrow": BAD_R002_NARROW,
    "r002-good": GOOD_R002.split("import torch")[0] + GOOD_R002.split(
        "from ..core import u64\n")[1].split("def route")[0],
    "r002-suppressed": BAD_R002_LITERAL.replace("w + 3", "w + 3  # repro: noqa[R002]"),
    "r007-pad": BAD_R007_PAD,
    "r007-sentinel": BAD_R007_SENTINEL,
    "r007-good": GOOD_R007,
    "r007-taint": R007_TAINT,
    "r008-blocking": BAD_R008_BLOCKING,
    "r008-unguarded": BAD_R008_UNGUARDED,
    "r008-good": GOOD_R008,
    "r008-span": BAD_R008_UNGUARDED.replace(
        "    def record_fast(self):\n        self.served += 1",
        "    def record_fast(self):\n        self.served = (  # repro: noqa[R008]\n"
        "            self.served + 1)"),
    "e999": "def f(:\n    pass\n",
}


@pytest.mark.parametrize("name", sorted(PARITY_SNIPPETS))
def test_numpy_halves_and_engine_match_the_reference(name):
    src = PARITY_SNIPPETS[name]
    select = ["R002", "R007", "R008"]

    def key(findings):
        return sorted((f.rule, f.line, f.col, f.suppressed) for f in findings)

    want = key(ref_engine.analyze_source(src, select=select))
    got = key(analyze_source(src, select=select))
    assert got == want
    if name != "r002-good" and not name.endswith("good") and name != "r007-taint":
        assert got, "a parity case that fires nothing tests nothing"


# ---------------------------------------------------------------------------
# cross-module reachability (phase-1 index)
# ---------------------------------------------------------------------------


def _write_pkg(tmp_path, a_src, b_src):
    pkg = tmp_path / "pkg"
    pkg.mkdir(exist_ok=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "a.py").write_text(a_src)
    (pkg / "b.py").write_text(b_src)
    return pkg


XMOD_HELPER = """
import torch

def helper(x: torch.Tensor):
    return x.tolist()
"""

XMOD_HOT_CALLER = """
from torch.profiler import record_function
from .b import helper

def step(x):
    with record_function("dedup.step"):
        return helper(x)
"""

XMOD_HOST_CALLER = """
from .b import helper

def prep(x):
    return helper(x)
"""


def _live_paths(paths, **kw):
    return [f for f in analyze_paths(paths, select=["R001"], **kw) if not f.suppressed]


def test_cross_module_hot_reachability_flags_the_helper(tmp_path):
    pkg = _write_pkg(tmp_path, XMOD_HOT_CALLER, XMOD_HELPER)
    findings = _live_paths([str(pkg)])
    assert _rules_of(findings) == {"R001"}
    assert all(f.path.endswith("b.py") for f in findings)


def test_cross_module_reachability_quiet_for_host_only_callers(tmp_path):
    assert _live_paths([str(_write_pkg(tmp_path, XMOD_HOST_CALLER, XMOD_HELPER))]) == []


def test_cross_module_reachability_through_package_reexport(tmp_path):
    pkg = _write_pkg(tmp_path, XMOD_HOT_CALLER.replace(
        "from .b import helper", "from . import helper"), XMOD_HELPER)
    (pkg / "__init__.py").write_text("from .b import helper\n")
    assert _rules_of(_live_paths([str(pkg)])) == {"R001"}


# ---------------------------------------------------------------------------
# on-disk findings cache
# ---------------------------------------------------------------------------


def test_cache_round_trip_returns_identical_findings(tmp_path):
    mod = tmp_path / "mod.py"
    mod.write_text(BAD_R001)
    cache = tmp_path / "cache.json"
    first = analyze_paths([str(mod)], cache_path=str(cache))
    assert cache.exists()
    second = analyze_paths([str(mod)], cache_path=str(cache))
    assert second == first and _rules_of(second) == {"R001"}


def test_cache_hits_skip_the_rule_run(tmp_path):
    mod = tmp_path / "mod.py"
    mod.write_text(BAD_R001)
    cache = tmp_path / "cache.json"
    analyze_paths([str(mod)], cache_path=str(cache))
    raw = json.loads(cache.read_text())
    (entry,) = raw["files"].values()
    entry["findings"][0]["message"] = "poisoned-cache-entry"
    cache.write_text(json.dumps(raw))
    got = analyze_paths([str(mod)], cache_path=str(cache))
    assert [f.message for f in got] == ["poisoned-cache-entry"]


def test_cache_invalidates_on_file_edit(tmp_path):
    mod = tmp_path / "mod.py"
    mod.write_text(BAD_R001)
    cache = tmp_path / "cache.json"
    assert _rules_of(analyze_paths([str(mod)], cache_path=str(cache))) == {"R001"}
    mod.write_text(GOOD_R001)
    assert analyze_paths([str(mod)], cache_path=str(cache)) == []


def test_cache_invalidates_when_a_dependency_changes_reachability(tmp_path):
    # b.py never changes; editing ONLY a.py puts b.helper on the hot path,
    # so the cache must re-check b.py
    pkg = _write_pkg(tmp_path, XMOD_HOST_CALLER, XMOD_HELPER)
    cache = tmp_path / "cache.json"
    assert _live_paths([str(pkg)], cache_path=str(cache)) == []
    (pkg / "a.py").write_text(XMOD_HOT_CALLER)
    loud = _live_paths([str(pkg)], cache_path=str(cache))
    assert _rules_of(loud) == {"R001"}
    assert all(f.path.endswith("b.py") for f in loud)


# ---------------------------------------------------------------------------
# self-hosting gate: the port and chip_smoke.py stay finding-free
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_findings():
    return analyze_paths([str(PORT), str(ROOT / "chip_smoke.py")])


@pytest.mark.parametrize("part", ["core", "kernels", "streaming", "serving", "data",
                                  "training", "chip_smoke.py"])
def test_self_hosting_port_is_clean(part, port_findings):
    where = str(ROOT / part) if part.endswith(".py") else str(PORT / part)
    live = [f.format() for f in port_findings
            if not f.suppressed and f.path.startswith(where)]
    assert live == [], "\n".join(live)


def test_every_suppression_gives_a_reason(port_findings):
    from repro_torch.analysis.engine import NOQA_RE
    bare = []
    for f in port_findings:
        if not f.suppressed:
            continue
        lines = pathlib.Path(f.path).read_text().splitlines()
        for lineno in range(f.line, 0, -1):
            m = NOQA_RE.search(lines[lineno - 1])
            if m:
                if len(lines[lineno - 1][m.end():].strip()) < 8:
                    bare.append(f"{f.path}:{lineno}")
                break
    assert bare == []


# ---------------------------------------------------------------------------
# the sync census: frame attribution and the inventory check
# ---------------------------------------------------------------------------


def _listed_sync():
    warnings.warn(f"{SYNC_MESSAGE} (test)")  # repro: noqa[R001] a synthetic sync in the inventory


def _unlisted_sync():
    warnings.warn(f"{SYNC_MESSAGE} (test)")


def _wrapper_module(tmp_path):
    """A module outside the census's roots that raises the warning, as
    torch's Python wrappers (torch.functional.unique) do."""
    path = tmp_path / "fake_torch_wrapper.py"
    path.write_text("import warnings\n\ndef unique(msg):\n    warnings.warn(msg)\n")
    spec = importlib.util.spec_from_file_location("fake_torch_wrapper", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _line_of(fn):
    return fn.__code__.co_firstlineno + 1


def test_census_attributes_sites_ranges_and_checks_the_inventory(tmp_path):
    wrapper = _wrapper_module(tmp_path)
    here = str(pathlib.Path(__file__).resolve().relative_to(ROOT))
    sync_before, rf = torch.cuda.synchronize, torch.autograd.profiler.record_function
    enter_before = rf.__enter__
    others = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda message, *a, **k: others.append(str(message))
        with SyncCensus(roots=[pathlib.Path(__file__).parent]) as census:
            with torch.profiler.record_function("stream.level"):
                _listed_sync()
                with torch.profiler.record_function("stream.rows"):
                    _listed_sync()
            wrapper_line = _line_of(test_census_attributes_sites_ranges_and_checks_the_inventory)
            wrapper.unique(f"{SYNC_MESSAGE} (wrapped)")  # repro: noqa[R001] held through a wrapper
            warnings.warn("an unrelated warning")
    assert others == ["an unrelated warning"]  # passed on, not counted
    assert torch.cuda.synchronize is sync_before and rf.__enter__ is enter_before
    listed = (here, _line_of(_listed_sync))
    wrapped = [s for s in census.sites if s[0] == here and s[1] > wrapper_line]
    assert census.sites[listed] == 2 and len(wrapped) == 1
    assert census.site_ranges[listed] == {"stream.level": 1, "stream.rows": 1}
    assert census.ranges == {"stream.level": 1, "stream.rows": 1, "(none)": 1}
    assert not census.outside and census.uncovered() == []
    census.check()
    assert census.lines("t")[0] == "census t: syncs=3 sites=2 armed=False"

    with SyncCensus(roots=[pathlib.Path(__file__).parent]) as census:
        _unlisted_sync()
    assert census.uncovered() == [((here, _line_of(_unlisted_sync)), 1)]
    with pytest.raises(AssertionError, match="outside the inventory"):
        census.check()


def test_census_lists_driver_sites_outside_the_port(tmp_path):
    with SyncCensus() as census:  # roots: the port; this file is outside it
        _unlisted_sync()
    (site,) = census.sites
    assert site in census.outside and census.uncovered() == []
    assert "outside the port" in census.lines("t")[-1]


def test_sync_guard_plugin_is_inert_without_the_flag():
    from repro_torch.analysis import sync_guard

    class Item:
        class config:
            @staticmethod
            def getoption(name):
                return False
        path = pathlib.Path("tests/test_torch_cuda.py")
        name = "test_radix_sort_kernel_matches_torch_sort"

    assert not sync_guard.guarded(Item)
    assert os.path.basename(sync_guard.GUARDED_FILE) == "test_torch_cuda.py"
