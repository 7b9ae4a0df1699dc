"""Host tools of the port, copies of the JAX package's tools/: merge
(shard outputs back into input order) and tab2fa (tabular <-> FASTA).
"""
