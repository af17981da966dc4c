"""NN units of the port: forward/gradient pairs with a numpy oracle path
and a torch device path."""
