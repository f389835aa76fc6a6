"""The benchmark's plain reference of the erasure codes it measures.

Worked out here from each codemode's definition (CubeFS
blobstore/common/codemode/codemode.go and blobstore/common/ec: a
systematic Reed-Solomon code over GF(2^8) with the 0x11D polynomial,
built from the Vandermonde matrix as klauspost/reedsolomon builds it,
and the LRC modes' local parity as an RS(ln, lm) code over each AZ's
stripe members). Matrices are numpy; the byte work is table lookups in
plain PyTorch on whichever device the tensors are on. Nothing here
imports the program.
"""
