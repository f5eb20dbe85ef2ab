"""Measurement entry points of the port that run on the card
(``python -m qubism_torch.experiments.<name>``)."""
