"""The plain reference that decides `correct`: PLINK bytes decoded and
standardized by plain torch, the SNP QC of the configuration's rules on
exact integer counts, and PCA by a float64 Gram or a blocked subspace
iteration.  It imports nothing of the program and takes nothing the
program made: the benchmark hands it the bytes it handed the program."""
