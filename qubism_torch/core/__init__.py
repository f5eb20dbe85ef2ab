"""Core value types: classical registers, primitive gates, state vectors."""
