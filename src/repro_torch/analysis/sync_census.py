"""Host-sync census: every synchronizing CUDA operation of a run, by site.

The runtime half of the analysis, the counterpart of the reference's
``--transfer-guard`` mode. ``SyncCensus`` is a context manager that runs
its body under ``torch.cuda.set_sync_debug_mode("warn")`` and records
each "called a synchronizing CUDA operation" warning:

- at its site, the innermost stack frame in the port (``src/repro_torch``
  outside this package). The warning's own frame can be torch's Python
  wrapper (``torch.functional.unique``, ``Stream.synchronize``), so the
  census walks the stack rather than trusting the warning's filename; a
  sync with no port frame on its stack (the driver's own code) is
  attributed to its innermost frame outside torch and listed as outside
  the port;
- under the innermost ``record_function`` range open on its thread,
  ``"(none)"`` where there is none (autograd runs the backward on a
  thread of its own, outside the ``train.*`` ranges).

torch's sync debug mode does not report ``torch.cuda.synchronize`` (nor
``Event.synchronize`` or ``elapsed_time``: measured on an H100 under
torch 2.11), so the census also wraps ``torch.cuda.synchronize`` and
counts each call at its site. On exit it restores the debug mode, the
warning filters, ``record_function`` and ``torch.cuda.synchronize`` as
it found them.

``check()`` fails on any site of the port whose line carries no
``# repro: noqa[R001]`` or ``noqa[R003]`` (on the line itself, or on the
first line of the statement around it): the static pass's suppressions
are the inventory of intended syncs, and the census holds a run to it.
"""
from __future__ import annotations

import collections
import os
import sys
import threading
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from .engine import NOQA_RE, noqa_map, parse_context

PORT_ROOT = Path(__file__).resolve().parents[1]
REPO_ROOT = PORT_ROOT.parents[1]
ANALYSIS_ROOT = Path(__file__).resolve().parent
TORCH_ROOT = Path(torch.__file__).resolve().parent
SYNC_MESSAGE = "called a synchronizing CUDA operation"
NO_RANGE = "(none)"
# the rules whose suppression marks an intended sync
INVENTORY_RULES = ("R001", "R003")

Site = Tuple[str, int]  # (path relative to the repo root, line)


def _under(path: str, root: Path) -> bool:
    try:
        Path(path).resolve().relative_to(root)
        return True
    except ValueError:
        return False


def _display(path: str) -> str:
    p = Path(path).resolve()
    try:
        return str(p.relative_to(REPO_ROOT))
    except ValueError:
        return str(p)


class SyncCensus:
    """Count the host syncs of the code run inside ``with``.

    ``sites`` counts them by ``(path, line)``, ``ranges`` by the innermost
    open profiler range, ``site_ranges`` both together. ``armed`` says
    whether the sync debug mode was on (it needs a CUDA device); without
    it only ``torch.cuda.synchronize`` calls and warnings raised by the
    code itself are seen.
    """

    def __init__(self, roots=(PORT_ROOT,), exclude=(ANALYSIS_ROOT,)):
        self.roots = tuple(Path(r).resolve() for r in roots)
        self.exclude = tuple(Path(r).resolve() for r in exclude)
        self.sites: collections.Counter = collections.Counter()
        self.ranges: collections.Counter = collections.Counter()
        self.site_ranges: Dict[Site, collections.Counter] = collections.defaultdict(
            collections.Counter)
        self.outside: set = set()  # sites with no port frame on their stack
        self.armed = False
        self._kinds: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._restore: List = []

    @property
    def total(self) -> int:
        return sum(self.sites.values())

    # -- recording -------------------------------------------------------

    def _stack(self) -> List[str]:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def _kind(self, path: str) -> str:
        """"port", "skip" (torch, this package, the warnings machinery) or
        "outside" for a frame's file; cached, since every sync walks a stack."""
        kind = self._kinds.get(path)
        if kind is None:
            if any(_under(path, r) for r in self.roots) \
                    and not any(_under(path, r) for r in self.exclude):
                kind = "port"
            elif _under(path, TORCH_ROOT) or _under(path, ANALYSIS_ROOT) \
                    or os.path.basename(path) == "warnings.py":
                kind = "skip"
            else:
                kind = "outside"
            self._kinds[path] = kind
        return kind

    def _site(self, frame) -> Tuple[Site, bool]:
        """(site, whether it is in the port) of the stack above ``frame``."""
        first_outside = None
        f = frame
        while f is not None:
            path = f.f_code.co_filename
            kind = self._kind(path)
            if kind == "port":
                return (_display(path), f.f_lineno), True
            if first_outside is None and kind == "outside":
                first_outside = (_display(path), f.f_lineno)
            f = f.f_back
        return first_outside or ("<native>", 0), False

    def record(self, frame) -> None:
        """Count one sync at the port frame at or above ``frame``."""
        site, inside = self._site(frame)
        stack = self._stack()
        rng = stack[-1] if stack else NO_RANGE
        with self._lock:
            if not inside:
                self.outside.add(site)
            self.sites[site] += 1
            self.ranges[rng] += 1
            self.site_ranges[site][rng] += 1

    def _showwarning(self, message, category, filename, lineno, file=None,
                     line=None):
        if SYNC_MESSAGE in str(message):
            self.record(sys._getframe(1))
        else:
            self._prev_show(message, category, filename, lineno, file, line)

    # -- context manager -------------------------------------------------

    def __enter__(self) -> "SyncCensus":
        census = self
        rf = torch.autograd.profiler.record_function
        enter, exit_ = rf.__enter__, rf.__exit__

        def rf_enter(r):
            out = enter(r)
            census._stack().append(r.name)
            return out

        def rf_exit(r, *exc):
            stack = census._stack()
            if stack:
                stack.pop()
            return exit_(r, *exc)

        rf.__enter__, rf.__exit__ = rf_enter, rf_exit
        self._restore.append(lambda: (setattr(rf, "__enter__", enter),
                                      setattr(rf, "__exit__", exit_)))

        cuda_sync = torch.cuda.synchronize

        def synchronize(device=None):
            census.record(sys._getframe(1))
            return cuda_sync(device)

        torch.cuda.synchronize = synchronize
        self._restore.append(lambda: setattr(torch.cuda, "synchronize", cuda_sync))

        caught = warnings.catch_warnings()
        caught.__enter__()
        self._restore.append(lambda: caught.__exit__(None, None, None))
        warnings.filterwarnings("always", message=SYNC_MESSAGE)
        warnings.filterwarnings("ignore", message="Synchronization debug mode")
        self._prev_show = warnings.showwarning
        warnings.showwarning = self._showwarning

        if torch.cuda.is_available():
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
            self.armed = True
            self._restore.append(lambda: torch.cuda.set_sync_debug_mode(mode))
        return self

    def __exit__(self, *exc) -> None:
        while self._restore:
            self._restore.pop()()

    # -- the inventory ---------------------------------------------------

    def top(self, n: int = 10) -> List[Tuple[Site, int]]:
        return sorted(self.sites.items(), key=lambda kv: (-kv[1], kv[0]))[:n]

    def uncovered(self) -> List[Tuple[Site, int]]:
        """Sites of the port whose line carries no R001/R003 suppression."""
        inv = Inventory()
        return [(site, n) for site, n in sorted(self.sites.items())
                if site not in self.outside and inv.reason(site) is None]

    def check(self) -> None:
        """Fail when a site is not in the inventory."""
        missing = self.uncovered()
        if missing:
            raise AssertionError(
                "host syncs outside the inventory (no `# repro: noqa[R001]` or "
                "`noqa[R003]` on the line or its statement's first line): "
                + ", ".join(f"{p}:{line} x{n}" for (p, line), n in missing))

    def lines(self, tag: str, n_top: int = 10) -> List[str]:
        """The census as printable lines: the total, the counts by range,
        and the ``n_top`` heaviest sites with their inventory reasons."""
        inv = Inventory()
        out = [f"census {tag}: syncs={self.total} sites={len(self.sites)} "
               f"armed={self.armed}",
               f"census {tag} by range: "
               + ", ".join(f"{r}={c}" for r, c in self.ranges.most_common())]
        for site, count in self.top(n_top):
            rng = ", ".join(f"{r}={c}" for r, c in self.site_ranges[site].most_common())
            reason = "outside the port" if site in self.outside else inv.reason(site)
            out.append(f"census {tag} site {site[0]}:{site[1]} count={count} "
                       f"ranges=[{rng}] reason={reason!r}")
        return out


class Inventory:
    """The ``noqa[R001]``/``noqa[R003]`` suppressions of the files the
    census reports, read from their sources once each."""

    def __init__(self):
        self._files: Dict[str, Optional[tuple]] = {}

    def _load(self, path: str):
        if path not in self._files:
            full = Path(path)
            if not full.is_absolute():
                full = REPO_ROOT / full
            try:
                src = full.read_text(encoding="utf-8")
            except OSError:
                self._files[path] = None
                return None
            ctx, _ = parse_context(src, str(full))
            self._files[path] = None if ctx is None else (ctx, noqa_map(ctx))
        return self._files[path]

    def reason(self, site: Site) -> Optional[str]:
        """The suppression comment covering ``site`` for R001 or R003 (its
        text after the rule list), or None when the site has none."""
        got = self._load(site[0])
        if got is None:
            return None
        ctx, noqa = got
        rules = noqa.get(site[1])
        if rules is None or (rules and not rules & set(INVENTORY_RULES)):
            return None
        for lineno in range(site[1], 0, -1):
            m = NOQA_RE.search(ctx.lines[lineno - 1])
            if m is not None:
                return ctx.lines[lineno - 1][m.end():].strip() or "(no reason)"
        return "(no reason)"
