"""The fleet router's scoring (a copy of ``kubeinfer_tpu/router/scoring.py``).

Only ``scoring`` is ported: the reconciler's placement cost reads its
queue pressure and constants. The router itself (``core``, ``server``)
is not ported yet.
"""
