"""Model builders of the port."""
