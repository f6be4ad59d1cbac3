"""User tools of the port's differentiable layer, twins of the JAX
package's ``tools/w2_gradient_flow.py`` and ``tools/tune_gn.py``: run as
``python -m ofot_tpu_torch.tools.<name>`` on the card, or with
``--platform cpu`` on the CPU, with their twins' flags and lines."""
