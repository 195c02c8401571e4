"""PyTorch/CUDA port of ``fall_multimodal_tpu`` for one NVIDIA H100.

The JAX package stays the reference; this package imports ``torch``, numpy
and yaml and nothing of it. Modules keep the JAX package's ``(N, T, V, C)``
layout at their public functions and the reference torch state_dict names,
so reference checkpoints load with a plain ``load_state_dict``.

Entry points (:class:`serve.Predictor`, the ``serve`` CLI) run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``; with no card
and no explicit CPU request they raise.
"""
