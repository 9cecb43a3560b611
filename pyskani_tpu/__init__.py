"""pyskani_tpu — an average-nucleotide-identity engine for NVIDIA GPUs.

A from-scratch reimplementation of the skani method (FracMinHash
sketching, marker-kmer screening, sparse anchor chaining, ANI/aligned-
fraction estimation) built on JAX/XLA/Pallas, exposing the same
public API as the ``pyskani`` reference package (Database / Sketch / Hit;
see /root/reference/src/pyskani/_skani.pyi for the mirrored surface).
"""

from .database import Database, Sketch
from .hit import Hit

__version__ = "0.1.0"
__author__ = "pyskani-tpu developers"

# Version of the skani *method* this engine reimplements (the reference
# binding embeds the wrapped crate version here; this framework is
# standalone, so the value documents method compatibility instead).
SKANI_VERSION = "0.3.0-compat"

__build__ = {
    "backend": "jax/xla/pallas",
    "dependencies": {"skani": SKANI_VERSION},
}

__all__ = ["Sketch", "Database", "Hit", "SKANI_VERSION"]
