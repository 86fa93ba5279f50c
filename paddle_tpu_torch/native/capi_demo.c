/* A deployment with no Python of its own: run a saved inference model
 * through libpaddle_capi (the reference's capi/examples/model_inference).
 *
 *   capi_demo MODEL_DIR PYTHON_PATH FEED DTYPE DIMS IN_FILE OUT_FILE
 *
 * FEED is the model's one feed, DTYPE its paddle_dtype code (0 float32,
 * 1 int64, 2 int32, 3 float64), DIMS its shape ("4,512"), IN_FILE its
 * row-major bytes.  Output 0's bytes go to OUT_FILE; the last line of
 * stdout is "CAPI_OK <dtype> <rank> <dims...> <bytes> <create_ms>
 * <run_ms>".  PYTHON_PATH (may be "") is appended to the embedded
 * interpreter's sys.path.  Built by native/capi.py build_demo. */
#include "capi.h"

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

static double now_ms(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1e3 + ts.tv_nsec / 1e6;
}

static int fail(const char* what, int code) {
  fprintf(stderr, "%s: %s\n", what, paddle_capi_last_error());
  return code;
}

int main(int argc, char** argv) {
  if (argc != 8) {
    fprintf(stderr,
            "usage: %s MODEL_DIR PYTHON_PATH FEED DTYPE DIMS IN_FILE "
            "OUT_FILE\n", argv[0]);
    return 1;
  }
  const int dtype = atoi(argv[4]);
  int64_t shape[8];
  int rank = 0;
  int64_t numel = 1;
  for (char* tok = strtok(argv[5], ","); tok != NULL && rank < 8;
       tok = strtok(NULL, ",")) {
    shape[rank] = atoll(tok);
    numel *= shape[rank++];
  }
  const size_t item = (dtype == PD_INT64 || dtype == PD_FLOAT64) ? 8 : 4;
  void* in = malloc(numel * item);
  FILE* f = fopen(argv[6], "rb");
  if (in == NULL || f == NULL ||
      fread(in, item, numel, f) != (size_t)numel) {
    fprintf(stderr, "cannot read %lld values from %s\n", (long long)numel,
            argv[6]);
    return 1;
  }
  fclose(f);

  const double t0 = now_ms();
  if (paddle_capi_init(argv[2]) != 0) return fail("init", 2);
  int64_t eng;
  if (paddle_inference_create(argv[1], &eng) != 0) return fail("create", 3);
  const double t1 = now_ms();
  if (paddle_inference_set_input(eng, argv[3], in, shape, rank,
                                 (paddle_dtype)dtype) != 0)
    return fail("set_input", 4);
  int n_out = 0;
  if (paddle_inference_run(eng, &n_out) != 0) return fail("run", 5);
  int64_t oshape[8];
  int orank = 0;
  paddle_dtype odtype;
  if (n_out < 1 ||
      paddle_inference_output_shape(eng, 0, oshape, 8, &orank) != 0 ||
      paddle_inference_output_dtype(eng, 0, &odtype) != 0)
    return fail("output", 6);
  int64_t bytes = (odtype == PD_INT64 || odtype == PD_FLOAT64) ? 8 : 4;
  for (int i = 0; i < orank; ++i) bytes *= oshape[i];
  void* out = malloc(bytes);
  if (out == NULL ||
      paddle_inference_output_data(eng, 0, out, bytes) != bytes)
    return fail("output_data", 6);
  const double t2 = now_ms();
  f = fopen(argv[7], "wb");
  if (f == NULL || fwrite(out, 1, bytes, f) != (size_t)bytes) {
    fprintf(stderr, "cannot write %s\n", argv[7]);
    return 1;
  }
  fclose(f);
  if (paddle_inference_release(eng) != 0) return fail("release", 7);
  if (paddle_capi_shutdown() != 0) return fail("shutdown", 7);
  printf("CAPI_OK %d %d", (int)odtype, orank);
  for (int i = 0; i < orank; ++i) printf(" %lld", (long long)oshape[i]);
  printf(" %lld %.3f %.3f\n", (long long)bytes, t1 - t0, t2 - t1);
  free(in);
  free(out);
  return 0;
}
