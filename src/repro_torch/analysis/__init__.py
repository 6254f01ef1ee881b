"""repro_torch.analysis: whole-program static analysis of the port.

``python -m repro_torch.analysis src/repro_torch chip_smoke.py`` runs the
rule pack over the port as a two-phase whole-program pass (phase 1
indexes the cross-module call graph and closes hot-path reachability
from every ``record_function`` range and kernel launch; phase 2 checks
each module, with an on-disk findings cache) and exits nonzero on any
unsuppressed finding. Each rule is the counterpart of the rule of
``repro.analysis`` with the same id; ``RULES.md`` beside this file gives
each rule's contract, the reference rule it mirrors and its known
imprecision. ``sync_census`` is the runtime half (every synchronizing
CUDA operation of a run, by site and profiler range) and
``sync_guard`` the pytest plugin that runs the card tests under it.
"""
from .engine import (  # noqa: F401
    AnalysisCache,
    Finding,
    ModuleContext,
    all_rules,
    analyze_file,
    analyze_paths,
    analyze_source,
    format_github,
    run_cli,
)
from .project import Project, module_name_for  # noqa: F401
