"""vln_bevbert_tpu_torch: the PyTorch / CUDA port of ``vln_bevbert_tpu``.

The JAX package stays the reference; this package mirrors its module paths and
class names (``vln_bevbert_tpu/models/encoders.py:GlobalMapEncoder`` has its
counterpart at ``vln_bevbert_tpu_torch/models/encoders.py:GlobalMapEncoder``)
and imports nothing of it, neither ``jax`` nor any ``vln_bevbert_tpu``
module: it keeps its own copy of the host layer it runs (``configs``,
``geometry``, ``data``, ``native``, ``nav.env``, ``nav.graph_map``,
``nav.eval_utils``, ``utils.logging``).

Ported so far: the navigation-eval slice (``bevbert-finetune --test``), the
pretraining train step (``bevbert-pretrain --synthetic``) and DAgger
fine-tuning (``bevbert-finetune``), object grounding, pretraining as users
run it, continuous environments (``ce/``: SS-BEV/SS-ETP, eval,
inference, and the DAgger trainer with its stores and env pool), and
data-parallel pretraining and fine-tuning (one process per card):

- ``ops``      : masking, the BEV projector, the CUDA splat and dropout kernels
- ``models``   : BERT blocks, the four encoders, the glocal backbone with its
                 pretraining heads and losses, the navigation model, and
                 Recurrent VLN-BERT (PREVALENT, ``models/legacy.py``)
- ``convert``  : flax parameter tree <-> ``state_dict``
- ``parallel`` : the optimizer family, the train step, the process group
                 and a rank's rows (``distributed``, ``mesh``)
- ``pretrain`` : the trainer over the MetaLoader task schedule
- ``nav``      : the navigation agent and the teacher-recollection store
- ``ce``       : continuous environments, the CE DAgger trainer, the env pool
- ``cli``      : ``finetune``, ``pretrain``, ``ce_train``, profilers

Hand-written CUDA sources live in ``csrc/``; ``csrc/ops.cpp`` binds them as
``torch.ops.bevbert`` operators, and ``_build.py`` compiles them with ``nvcc``
at first use into one library under ``build/`` at the checkout's root.
"""

__version__ = "0.1.0"
