"""vln_bevbert_tpu_torch: the PyTorch / CUDA port of ``vln_bevbert_tpu``.

The JAX package stays the reference; this package mirrors its module paths and
class names (``vln_bevbert_tpu/models/encoders.py:GlobalMapEncoder`` has its
counterpart at ``vln_bevbert_tpu_torch/models/encoders.py:GlobalMapEncoder``)
and imports the JAX-free host layer of the JAX package (``configs``,
``geometry``, ``data``, ``nav.env``, ``nav.graph_map``, ``nav.eval_utils``)
instead of copying it. It never imports ``jax``.

Ported so far: the navigation-eval slice (``bevbert-finetune --test``):

- ``ops``      : masking, the BEV projector, the CUDA splat kernel, dropout
- ``models``   : BERT blocks, the four encoders, the glocal backbone and the
                 navigation model
- ``convert``  : flax parameter tree -> ``state_dict``
- ``nav``      : the greedy-eval navigation agent
- ``cli``      : ``python -m vln_bevbert_tpu_torch.cli.finetune --test``

Hand-written CUDA sources live in ``csrc/`` and are compiled with ``nvcc`` at
first use into ``build/`` at the checkout's root (``_build.py``).
"""

__version__ = "0.1.0"
