"""The frozen arithmetic of the benchmark: the card's published peaks and
the operations and bytes that each kernel's inputs need."""
