"""Graph containers, the Fiedler front end and rounding."""
