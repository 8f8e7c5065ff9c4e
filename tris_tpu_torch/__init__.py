"""TRIS in PyTorch for NVIDIA Hopper: the stage-1 eval path of the JAX
package ``tris_tpu``, with hand-written CUDA kernels where that package used
hand-shaped XLA programs. Imports torch and numpy only."""
