// Fast OpenQASM 2.0 tokenizer (native core of qubism_torch.qasm.lexer).
//
// The Python lexer is the semantics reference; this C++ core exists for
// machine-generated circuit files (benchmark QASM for 30+ qubit circuits
// easily reaches megabytes), where Python tokenization dominates parse
// time. Token classification (keyword vs identifier, symbol identity)
// stays in Python — the native layer only finds token boundaries, kinds,
// numeric values and source positions.
//
// Contract (see qubism_torch/native/__init__.py):
//   kinds: 0=word 1=nat 2=real 3=symbol 4=string 5=:dump
//   starts/lengths: byte spans into the source (strings: contents only)
//   values: numeric value for nat/real tokens
//   lines/cols: 1-based source positions
// Returns the token count, or a negative error code:
//   -1 capacity exceeded, -2 unterminated block comment,
//   -3 unterminated string, -4 unexpected character
// On error, *err_pos is the byte offset of the problem.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

static inline bool is_alpha(char c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z');
}
static inline bool is_digit(char c) { return c >= '0' && c <= '9'; }
static inline bool is_alnum(char c) { return is_alpha(c) || is_digit(c); }

long qasm_lex(const char* src, long len,
              uint8_t* kinds, long* starts, long* lengths, double* values,
              long* lines, long* cols, long max_tokens, long* err_pos) {
  long i = 0, line = 1, col = 1, count = 0;

  auto advance = [&](long k) {
    for (long j = 0; j < k; ++j) {
      if (src[i] == '\n') { line += 1; col = 1; } else { col += 1; }
      i += 1;
    }
  };

  while (i < len) {
    char c = src[i];
    if (c == ' ' || c == '\t' || c == '\r' || c == '\n') { advance(1); continue; }
    if (c == '/' && i + 1 < len && src[i + 1] == '/') {
      while (i < len && src[i] != '\n') advance(1);
      continue;
    }
    if (c == '/' && i + 1 < len && src[i + 1] == '*') {
      long j = i + 2;
      while (j + 1 < len && !(src[j] == '*' && src[j + 1] == '/')) ++j;
      if (j + 1 >= len) { *err_pos = i; return -2; }
      advance(j + 2 - i);
      continue;
    }
    if (count >= max_tokens) { *err_pos = i; return -1; }
    long tl = line, tc = col;

    if (c == ':' && i + 4 < len && memcmp(src + i, ":dump", 5) == 0) {
      kinds[count] = 5; starts[count] = i; lengths[count] = 5;
      values[count] = 0; lines[count] = tl; cols[count] = tc;
      ++count; advance(5); continue;
    }
    if (c == '"') {
      long j = i + 1;
      while (j < len && src[j] != '"' && src[j] != '\n') ++j;
      if (j >= len || src[j] != '"') { *err_pos = i; return -3; }
      kinds[count] = 4; starts[count] = i + 1; lengths[count] = j - i - 1;
      values[count] = 0; lines[count] = tl; cols[count] = tc;
      ++count; advance(j + 1 - i); continue;
    }
    if (is_alpha(c)) {
      long j = i + 1;
      while (j < len && is_alnum(src[j])) ++j;
      kinds[count] = 0; starts[count] = i; lengths[count] = j - i;
      values[count] = 0; lines[count] = tl; cols[count] = tc;
      ++count; advance(j - i); continue;
    }
    if (is_digit(c)) {
      long j = i;
      while (j < len && is_digit(src[j])) ++j;
      bool is_real = false;
      if (j < len && src[j] == '.' && j + 1 < len && is_digit(src[j + 1])) {
        is_real = true; ++j;
        while (j < len && is_digit(src[j])) ++j;
      }
      if (j < len && (src[j] == 'e' || src[j] == 'E')) {
        long k = j + 1;
        if (k < len && (src[k] == '+' || src[k] == '-')) ++k;
        if (k < len && is_digit(src[k])) {
          is_real = true; j = k;
          while (j < len && is_digit(src[j])) ++j;
        }
      }
      char buf[64];
      long n = j - i < 63 ? j - i : 63;
      memcpy(buf, src + i, n); buf[n] = 0;
      kinds[count] = is_real ? 2 : 1;
      starts[count] = i; lengths[count] = j - i;
      values[count] = strtod(buf, nullptr);
      lines[count] = tl; cols[count] = tc;
      ++count; advance(j - i); continue;
    }
    // symbols (longest first: -> ==)
    long sl = 0;
    if (c == '-' && i + 1 < len && src[i + 1] == '>') sl = 2;
    else if (c == '=' && i + 1 < len && src[i + 1] == '=') sl = 2;
    else if (strchr(";,()[]{}+-*/", c)) sl = 1;
    if (sl > 0) {
      kinds[count] = 3; starts[count] = i; lengths[count] = sl;
      values[count] = 0; lines[count] = tl; cols[count] = tc;
      ++count; advance(sl); continue;
    }
    *err_pos = i;
    return -4;
  }
  return count;
}

}  // extern "C"
