"""The loops a traffic mix drives, one module per ``driver`` name."""
