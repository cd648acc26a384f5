"""Model zoo of the port: configs, layers and the dense transformer."""
