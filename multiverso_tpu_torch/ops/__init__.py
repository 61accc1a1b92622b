"""Device kernels: the row scatter/gather (:mod:`.rows`), word2vec's chunk
step (:mod:`.sgns`) and their build helper (:mod:`.kernels`)."""
