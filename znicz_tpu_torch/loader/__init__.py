"""Data loaders of the port: the minibatch server, the full-batch loader
and the seeded synthetic datasets."""
