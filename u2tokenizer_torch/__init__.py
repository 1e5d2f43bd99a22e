"""μ²-TPU's PyTorch/CUDA port for NVIDIA Hopper.

The report path (a NIfTI file and a trained checkpoint in, report text
out), the serving path and the SFT training path of the JAX package
(``u2tokenizer_tpu``) rebuilt on PyTorch, with the
attention hot spots, forward and backward, in hand-written CUDA kernels
(``csrc/``). The module layout mirrors the JAX
package. Entry points run on the GPU unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper computes its plain
PyTorch version instead.
"""

__version__ = "0.1.0"

from .config import (  # noqa: F401
    GenerationConfig,
    LLMConfig,
    MeshConfig,
    ProjectorConfig,
    TrainConfig,
    U2ModelConfig,
    U2TokenizerConfig,
    VisionConfig,
)
