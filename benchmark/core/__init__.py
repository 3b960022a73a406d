"""The benchmark's harness: finds a cell's pieces by name, runs the cell's
driver, reads its metrics and prints the result line."""
