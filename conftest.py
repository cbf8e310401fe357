"""The order in which pytest-xdist deals the test files to its workers.

Under `--dist loadfile` xdist deals whole files, by default the files
with the most tests first (`--loadscope-reorder`). A file that runs for
minutes but holds few tests is then dealt last, and its end is the end
of the run. Here those files are dealt first and the rest as xdist
would. Only the order changes; imports no JAX. An explicit
`--loadscope-reorder` on the command line keeps xdist's own order.
"""

import collections

import pytest

#: Files dealt first, in this order: each runs for minutes in one worker
#: but holds few tests.
DEAL_FIRST = (
    "test_slab.py",
    "test_content_interact.py",
    "test_pallas_trace.py",
    "test_render_goldens.py",
    "test_pallas_relight.py",
    "test_torch_converge.py",
    "test_bounce_flaws.py",
    "test_torch_slice.py",
    "test_parallel.py",
)


def pytest_configure(config):
    # xdist's sort off: the files are dealt in the order in which the
    # workers collect them, which the hook below sets.
    if (getattr(config.option, "dist", "no") == "loadfile"
            and "--loadscope-reorder" not in config.invocation_params.args):
        config.option.loadscopereorder = False


@pytest.hookimpl(trylast=True)  # after `-m` and `-k` deselect
def pytest_collection_modifyitems(config, items):
    """DEAL_FIRST's files first, then the rest most tests first, each
    file's tests kept together and in their order."""
    if not hasattr(config, "workerinput"):  # not an xdist worker
        return
    counts = collections.Counter(item.path for item in items)
    rank = {name: i for i, name in enumerate(DEAL_FIRST)}
    items.sort(key=lambda item: (rank.get(item.path.name, len(rank)), -counts[item.path]))
