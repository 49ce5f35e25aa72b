"""vmrframe_tpu_torch: the PyTorch/CUDA port of vmrframe_tpu for NVIDIA Hopper.

It imports nothing of ``vmrframe_tpu`` (nor JAX): what it needs of that
package it keeps as its own copy.  Entry points run on ``cuda`` unless the
caller asks for ``cpu``; without a card and without that request they raise.
"""
