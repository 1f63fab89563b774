"""Two intra-op threads for torch in the port's CPU tests.

The tier-1 command runs six pytest-xdist workers on a machine of about as
many cores; with torch's default of one intra-op thread a core in each
worker, beside XLA's own pool, the workers oversubscribe the cores. On an
8-core CPU machine, six copies of ``test_torch_port_decomp_eval.py`` at once
took 153 s with the default and 44 s with one thread each (38 s alone,
against 58 s with the default). Two, not one: a float32 sum split over two threads keeps
``test_torch_port_train_extras.py``'s remat gradients (the decoder's final
conv summed region by region against once over all frames) within their
1e-6 of the largest leaf, as with the default; one thread's single running
sum does not (2.8e-7 against a limit of 1.4e-7). A fixed count also fixes
the summation order whatever the machine's cores. Every
``test_torch_port_*.py`` but the card's imports this module, so each worker
sets it while it collects.
"""

import torch

torch.set_num_threads(2)
