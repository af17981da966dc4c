"""Data loaders of the port: the minibatch server, the full-batch loader,
the seeded synthetic datasets, the MNIST IDX and CIFAR pickle file
loaders, the directory-per-class image-file loaders, and the
normalizers."""
