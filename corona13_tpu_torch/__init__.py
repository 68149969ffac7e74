"""corona13_tpu_torch — the PyTorch/CUDA port of corona13_tpu.

The JAX package ``corona13_tpu`` is the reference; this package mirrors
its module paths (``ops/trace.py`` here is ``corona13_tpu/ops/trace.py``
there) and holds the same functions on torch tensors.  Its kernels, the
BVH traversal of every prim kind (``ops/trace_cuda.py``), are written in
CUDA C++ for the H100 (``csrc/``).  The package imports torch and numpy and
nothing of jax or of ``corona13_tpu``: the host code it needs (the numpy
BVH builder, the ``.nra2``/``.geo``/``.vol``/``.cam``/``.fb``/``.pfm``
readers and writers, the CIE tables) is carried in ``ops/bvh.py``, ``io/``
and ``spectral/_cie_data.py``.  ``python -m corona13_tpu_torch scene.nra2``
is the pt/ptdl command line.
"""

__version__ = '0.1.0'
