"""Tools of the PyTorch port: measurement entry points run on the card."""
