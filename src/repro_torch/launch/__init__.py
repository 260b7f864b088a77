"""Entry points: the model server and the fleet, and the trainer."""
