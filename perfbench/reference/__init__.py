"""The plain reference the benchmark judges the program by: Python ints
and NumPy only.  It imports neither JAX nor anything of ``vdf_tpu`` or
``vdf_tpu_torch``, and takes nothing the program made: it works out the
shapes, generators and transcripts again (``frozen/``, a copy of the
port's host-int circuit code) and reads the program's outputs only to
judge them.
"""
