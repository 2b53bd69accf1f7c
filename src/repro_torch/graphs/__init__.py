# Synthetic graphs and layouts (numpy copies of repro.graphs).
