"""Model families of the seed-template substrate (the LM serving path so
far)."""
