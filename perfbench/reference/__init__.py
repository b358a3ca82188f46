"""The plain reference the benchmark holds the program against: frozen
input generators, the graph encoding and the batched event loop."""
