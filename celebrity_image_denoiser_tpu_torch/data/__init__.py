"""Host-side image decode/encode (stdlib PNG codec) and normalisation."""
