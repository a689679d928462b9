"""FemBrain: a differentiable implicit-surface surgical simulation
framework in JAX (XLA, with Pallas kernels on the GPU), built from scratch
with the capabilities of the FemBrain reference (BlobTree modeling,
polygonization, FEM deformation, haptics, cutting)."""

__version__ = "0.1.0"
