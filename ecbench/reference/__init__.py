"""The plain reference the benchmark holds the program's outputs against:
NumPy only, importing nothing of the program under test.  It works the
shards, the .ecx and the payloads out again from the .dat and .idx that
the benchmark's generator (ecbench/volume.py) wrote."""
