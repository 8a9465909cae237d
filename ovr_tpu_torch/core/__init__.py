"""Scene model, value types and sampling math."""
