"""Host-side builders (numpy), state helpers and the random source."""
