"""The benchmark's plain reference: CoPoNeRF's math in plain torch, f32.

A frozen copy of the port's model, losses and geometry with every kernel
replaced by its plain torch expression (``models/coponerf.py`` lists
them), and a plain train step (``train.py``).  It imports nothing of the
port, of the JAX package or of JAX.
"""
