"""Model layer of the port: attention, MLP and the stacked decoder."""
