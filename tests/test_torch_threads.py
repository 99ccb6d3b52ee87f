"""torch's CPU threads in the pytest-xdist workers.

Each xdist worker runs torch at its default intra-op thread count, which
is the machine's CPU count, so W workers on C CPUs would run W * C
threads and slow every torch test many times over. The workers collect
every test module before any of them runs a test, so the code at module
level below runs in each worker before any test does. Where
PYTEST_XDIST_WORKER is set it caps torch at cpu_count // workers threads
(at least 1), and sets OMP_NUM_THREADS and MKL_NUM_THREADS to the same
number so that the child processes the tests start (the command line's
`python -m` runs, the import checks' scripts) inherit the cap. It changes
no check, only the threads. A serial run (no xdist) is left as it is.
"""

import os
import subprocess
import sys

import torch


def _cap():
    """The threads each worker may use, or None outside an xdist worker."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return None
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 1)
    return max(1, (os.cpu_count() or 1) // max(workers, 1))


CAP = _cap()
if CAP is not None:
    os.environ["OMP_NUM_THREADS"] = str(CAP)
    os.environ["MKL_NUM_THREADS"] = str(CAP)
    torch.set_num_threads(CAP)


def test_worker_and_its_children_run_at_the_cap():
    child = subprocess.run(
        [sys.executable, "-c",
         "import torch; print(torch.get_num_threads())"],
        capture_output=True, text=True, check=True, env=dict(os.environ))
    n_child = int(child.stdout.strip().splitlines()[-1])
    if CAP is None:
        # a serial run keeps torch's own choice, in this process and a child
        assert n_child == torch.get_num_threads()
    else:
        assert torch.get_num_threads() == CAP
        assert n_child == CAP
