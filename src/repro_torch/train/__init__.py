"""Train step and trainer loop."""
