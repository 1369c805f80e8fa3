"""General drivers of the traffic mixes, one a ``loop`` kind."""
