"""The plain reference: BLS12-377 field, G1 and the KZG10 and Marlin checks
in Python integers and NumPy.  Imports neither JAX nor the JAX package nor
anything of the program under test, and takes nothing the program made: the
benchmark hands it the inputs it drew from the seed and the outputs it is
to judge."""
