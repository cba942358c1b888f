"""The benchmark's harness: manifest lookup, guards, the eval loop, the
trace reduction and the comparison with the plain reference."""
