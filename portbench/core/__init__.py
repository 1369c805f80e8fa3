"""The harness: data, cells, traces, comparisons and the result line."""
