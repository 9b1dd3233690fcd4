"""A frozen copy of the port's host-int circuit code, so that the reference
works out the R1CS shapes, the transcripts and the generators itself.

Copied from ``vdf_tpu_torch`` (``fields/params.py``, ``fields/int_field.py``,
``poseidon/params.py``, ``poseidon/int_poseidon.py``, ``r1cs/cs.py``,
``r1cs/gadgets.py``, ``r1cs/bits.py``, ``nova/augmented.py``,
``nova/circuit.py``, ``nova/gadgets/*``, ``curves/int_ops.py`` and the
host helpers of ``curves/point.py``) with the module layout kept, so the
relative imports read as in the original.  Departures: no native library
(the Poseidon rounds and the EC fold run in Python), no tensor witness
(``circuit.py`` and ``augmented.py`` keep shape synthesis only).  Nothing
here imports the port, and the port imports nothing here.
"""
