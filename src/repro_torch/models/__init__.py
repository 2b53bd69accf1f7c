"""Model families of the seed-template substrate: the LM, GNN, recsys
and equivariant families."""
