"""One intra-op thread for torch in the port's CPU tests, which import this
module.

The suite runs under pytest-xdist with several workers on one machine's
cores.  At torch's default of one intra-op thread per core in every worker,
the workers' thread pools contend for the same cores, and the port's
small-width tests (tensors of a few thousand elements, where a thread pool
gains nothing) run many times slower than alone.  The setting is
process-wide, so it holds for whatever else a worker runs after collecting
these files.
"""

import torch

torch.set_num_threads(1)
