"""Runnable examples of the port, twins of the JAX package's ``examples/``.

Each runs as ``python -m ofot_tpu_torch.examples.<name>`` on the card, or
with ``--platform cpu`` on the CPU, and prints the lines of its JAX twin
(the same labels and formats, so that the two outputs compare line by
line).  Each ``main(argv=None)`` also returns the numbers it printed, at
full precision:

  * ``quickstart``: FOTO (``foto.DCT_OPS``) and GN on a moving square;
  * ``unbalanced_flow``: FOTO against WFR on a blob that brightens 40%;
  * ``wasserstein``: dynamic W2 (ALG2) against the entropic W2 (Sinkhorn);
  * ``differentiable_ot``: the gradient of the Sinkhorn divergence through
    ``torch.autograd`` and two mirror-descent steps;
  * ``sharded_solve``: the tiled FOTO solve on a (y, x) mesh of ranks.
"""

from __future__ import annotations

import argparse

from ofot_tpu_torch.parallel import sweep


def parse(argv, doc: str) -> argparse.Namespace:
    """The examples' one flag, ``--platform cuda|cpu`` (default cuda),
    and ``device``, the torch device it names (``cuda`` without a card
    raises)."""
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    p.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                   help="torch device to run on (default cuda; no card "
                        "raises, there is no fallback to the CPU)")
    args = p.parse_args(argv)
    args.device = sweep.torch_device(args.platform)
    return args
