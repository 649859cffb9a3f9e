"""distributed_deep_q_tpu_torch — the PyTorch/CUDA port of distributed_deep_q_tpu.

A second package beside the JAX reference, ported one slice at a time and
held to the reference by tests that run both on the same inputs. It imports
``torch`` and never ``jax`` or the reference package. Ported so far: the
fused device-PER pixel trainer (the Pong preset's path), with the frame
ring's gather and scatter as hand-written CUDA kernels for Hopper
(``csrc/ring_gather.cu``). Entry point: ``python -m
distributed_deep_q_tpu_torch.main train --preset pong --backend cuda``.

Importing the package builds nothing and touches no device.
"""

__version__ = "0.1.0"
