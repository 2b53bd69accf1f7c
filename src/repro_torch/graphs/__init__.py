# Synthetic graphs, layouts and graph batches (numpy copies of
# repro.graphs) and the neighbour sampler on PyTorch.
