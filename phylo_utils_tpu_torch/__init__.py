"""phylo_utils_tpu_torch: the PyTorch/CUDA port of ``phylo_utils_tpu``.

Felsenstein-pruning log-likelihoods on an NVIDIA GPU (or the CPU), held
against the JAX package on the same inputs. Import the modules you need
(``likelihood``, ``server``, ``models``, ``io``, ``trees``, ``ops``);
importing the package loads no kernel: ``ops/_build.py`` compiles
``csrc/*.cu`` with ``nvcc`` at the first CUDA launch.
"""

__version__ = "0.1.0"
