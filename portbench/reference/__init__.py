"""The plain reference of a SAFE analysis, in plain torch (f64 by default).

It computes from the network arrays, the attribute set and the permutations
that the benchmark made, with upstream SAFE's semantics (safepy): a node's
neighborhood is every node whose weighted shortest-path distance over the
edge lengths is at most the radius; a quantitative score is the sum of the
annotated values over the neighborhood; the null rescores every neighborhood
under each permutation of the annotated values and counts ``null <= obs`` and
``null >= obs``. It imports nothing of the program, nor ``jax``, and needs no
ordering, band or window: those are the program's own devices.

``lowered=True`` computes the same in the nearest precision below the one
the program states (float32 with TF32 off): the distances in bfloat16 and
the score contractions in TF32. That is the control, which the comparison
must refuse.
"""
