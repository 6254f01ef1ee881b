"""pytest plugin: run the port's hot-path card tests under the sync census.

    PYTHONPATH=src python -m pytest -p repro_torch.analysis.sync_guard \\
        --sync-guard -m cuda tests/test_torch_cuda.py

The counterpart of the reference's ``--transfer-guard`` mode. With
``--sync-guard`` the pairs, sort, streaming and serving cases of
``tests/test_torch_cuda.py`` run under ``SyncCensus``, and a case fails
when one of its syncs happens at a site of the port that the inventory
(the ``# repro: noqa[R001]`` / ``noqa[R003]`` suppressions) does not
list; the tests' own comparisons sync freely. It is a plugin because
``conftest.py`` belongs to the reference. Without the flag, or without a
CUDA device, it does nothing.
"""
from __future__ import annotations

import pytest

GUARDED_FILE = "test_torch_cuda.py"
# the hot-path cases: the pair decode, the radix sort, streaming (the
# store's sketch fold and the sharded store) and serving
GUARDED_CASES = ("tri_decode", "sort_pass", "radix_sort", "streaming",
                 "sharded", "level_cms", "dedupe_service", "serving_engine")


def pytest_addoption(parser):
    parser.addoption(
        "--sync-guard", action="store_true", default=False,
        help="run the port's pairs/sort/streaming/serving card tests under "
        "the host-sync census and fail on a sync outside the inventory")


def guarded(item) -> bool:
    if not item.config.getoption("--sync-guard"):
        return False
    if item.path.name != GUARDED_FILE or not any(
            case in item.name for case in GUARDED_CASES):
        return False
    import torch
    return torch.cuda.is_available()


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    if not guarded(item):
        return (yield)
    from .sync_census import SyncCensus
    with SyncCensus() as census:
        result = yield
    census.check()
    return result
