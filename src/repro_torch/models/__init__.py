"""Functional models of the port: the paper CNNs over a pluggable GEMM
(``cnn``), the numeric oracle the compiled programs are held against."""
